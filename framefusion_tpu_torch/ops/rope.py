"""Rotary position embeddings: standard RoPE and Qwen2-VL's mRoPE (port of
``framefusion_tpu.ops.rope``).

HF Qwen2's half-rotation layout (``rotate_half``). The carried object is the
integer positions (1D, or three streams for mRoPE); cos/sin are recomputed
from them, which stays exact under compaction. mRoPE follows HF Qwen2-VL's
``apply_multimodal_rotary_pos_emb``: the head_dim/2 frequency slots are
split into sections, section i taking its angles from stream i % 3
(temporal, height, width).
"""

from __future__ import annotations

import torch


def _angles(position_ids: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(..., S, head_dim/2) fp32 rotation angles of integer positions (..., S)."""
    dev = position_ids.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim))
    return position_ids.to(torch.float32)[..., None] * inv_freq


def _cos_sin(freqs: torch.Tensor):
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, head_dim) fp32, for integer positions (..., S)."""
    return _cos_sin(_angles(position_ids, head_dim, theta))


def mrope_cos_sin(position_ids_3d: torch.Tensor, head_dim: int, theta: float, mrope_section):
    """Multimodal RoPE cos/sin from 3 position streams.

    Args:
        position_ids_3d: (3, ..., S) integer (temporal, height, width)
            positions.
        mrope_section: section sizes over the head_dim/2 frequency slots
            (summing to head_dim/2); section i uses stream i % 3.
    Returns:
        (cos, sin), each (..., S, head_dim) fp32. The angles are selected
        per slot before the cos and sin, so three equal streams give
        ``rope_cos_sin``'s tables bit for bit.
    """
    if sum(mrope_section) != head_dim // 2:
        raise ValueError(f"mrope_section {tuple(mrope_section)} must sum to head_dim/2 = {head_dim // 2}")
    freqs3 = _angles(position_ids_3d, head_dim, theta)  # (3, ..., S, hd/2)
    parts, start = [], 0
    for i, sec in enumerate(mrope_section):
        parts.append(freqs3[i % 3, ..., start:start + sec])
        start += sec
    return _cos_sin(torch.cat(parts, dim=-1))


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
