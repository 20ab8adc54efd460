"""Bidirectional attention for the vision towers: CUDA kernel E, its plain
version, and the JAX package's entry point.

Counterpart of ``framefusion_tpu/ops/kernels/bidir_attention.py``. The TPU
kernel padded N and the head dim to 128 in device memory and held a whole
(N, N) fp32 score tile in VMEM; on the card K/V stream through shared memory
with an online softmax, the keys past N are masked in the kernel and the
head dim is zero-filled to a multiple of 16 in shared memory only
(``csrc/bidir_attention.cu``, whose header says what bounds the kernel and
how the design meets it).

``bidir_attn_fwd`` runs its plain PyTorch version when the tensors lie on
the CPU and launches the kernel when they lie on a CUDA device; anything
else raises. ``bidir_attn_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from .flash_prefill import _check_cuda, _device_route

MAX_HEAD_DIM = 128


def _check_inputs(q, k, v):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (B, N, H, hd) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def bidir_attn_fwd_plain(q, k, v, scale: float):
    """Plain version of kernel E: the einsum/softmax of the JAX tower's
    reference path (``siglip.py:178-181``), in fp32 throughout."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32)).to(q.dtype)


def bidir_attn_fwd(q, k, v, scale: float):
    """Kernel E: non-causal softmax attention per (batch, head).

    Args:
        q, k, v: (B, N, H, hd), bf16 and contiguous on the card; hd a
            multiple of 8 up to 128, any N.
        scale: the softmax scale (1/sqrt(hd) for the towers).
    Returns:
        (B, N, H, hd) in q's dtype.
    """
    _check_inputs(q, k, v)
    if not _device_route("bidir_attn_fwd", q):
        return bidir_attn_fwd_plain(q, k, v, scale)
    b, n, h, hd = q.shape
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"bidir_attn_fwd: CUDA kernel takes a head_dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    _check_cuda("bidir_attn_fwd", q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bidir_attn_fwd: CUDA kernel takes 16-byte aligned tensors")
    from ... import _build

    lib = _build.load_library()
    out = torch.empty_like(q)
    status = lib.ff_bidir_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   b, n, h, hd, float(scale), _build.stream_ptr(q.device))
    _build.check(status, "bidir_attn_fwd")
    bidir_attn_fwd.launches += 1
    return out


bidir_attn_fwd.launches = 0


def flash_bidir_attention(q, k, v, *, scale=None):
    """Fused non-causal attention: q/k/v (B, N, H, hd) -> (B, N, H, hd).

    All N keys attend to all N queries (ViT encoder semantics). ``scale``
    defaults to 1/sqrt(hd).
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return bidir_attn_fwd(q, k, v, scale)
