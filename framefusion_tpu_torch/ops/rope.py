"""Rotary position embeddings (port of ``framefusion_tpu.ops.rope``).

HF Qwen2's half-rotation layout (``rotate_half``). The carried object is the
integer position vector; cos/sin are recomputed from it, which stays exact
under compaction.
"""

from __future__ import annotations

import torch


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, head_dim) fp32, for integer positions (..., S)."""
    dev = position_ids.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim))
    freqs = position_ids.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q: (S, Hq, D), k: (S, Hk, D); cos/sin: (S, D) fp32. Math in fp32."""
    c = cos[:, None, :]
    s = sin[:, None, :]
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    q_out = qf * c + _rotate_half(qf) * s
    k_out = kf * c + _rotate_half(kf) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)
