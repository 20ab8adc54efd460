"""Ragged decode attention: CUDA kernel G, its plain version, the entry point.

Counterpart of ``framefusion_tpu/ops/kernels/decode_attention.py``. Decode
after a compressed prefill attends per-layer caches of different lengths
padded into one pool; one query token attends the first ``cache_len`` keys
of its layer's (S_view, Hk, D) view, the current token included.

* ``ragged_decode_attn`` (kernel G, ``csrc/decode_attention.cu``, whose
  header says what bounds it and how the design meets that) — split-K flash
  decoding: (n_split, Hk) CTAs over 64-key tiles below ``cache_len`` only,
  then a fixed-order combine of the splits.
* ``ragged_decode_attn_plain`` — the masked fp32 einsum of
  ``ops.attention.decode_attention`` over the whole view.

The wrapper runs the plain version when the tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
``ragged_decode_attn.launches`` counts kernel launches (the split pass and
its combine count as one). ``cache_len`` is a host int, as kernel C's layer
index is.

``ragged_decode_attention`` keeps the JAX package's entry point.
"""

from __future__ import annotations

import math

import torch

from ..attention import decode_attention
from .flash_prefill import HEAD_DIM, _check_cuda, _device_route

TILE_KEYS = 64
# Target CTAs per launch (about four per SM of an H100's 132; on the card,
# 264 and 1,056 timed within 10% of it at the 64-frame decode lengths).
TARGET_CTAS = 528


def _check_inputs(q, k_cache, v_cache, cache_len: int) -> None:
    if q.ndim != 2 or k_cache.ndim != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(f"expected q (Hq, D), caches (S, Hk, D); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    s_view, hk, d = k_cache.shape
    if q.shape[1] != d or q.shape[0] % hk:
        raise ValueError(f"incompatible q {tuple(q.shape)} and cache {tuple(k_cache.shape)}")
    if not 0 < cache_len <= s_view:
        raise ValueError(f"cache_len must be in [1, {s_view}], got {cache_len}")
    if len({q.device, k_cache.device, v_cache.device}) != 1:
        raise ValueError("inputs on several devices")


def split_plan(cache_len: int, hk: int) -> tuple[int, int]:
    """(keys_per_split, n_split): whole 64-key tiles per CTA so that about
    ``TARGET_CTAS`` CTAs cover the live keys; no CTA starts past the length."""
    tiles = -(-cache_len // TILE_KEYS)
    want = max(1, TARGET_CTAS // hk)
    keys_per_split = -(-tiles // want) * TILE_KEYS
    return keys_per_split, -(-cache_len // keys_per_split)


def ragged_decode_attn_plain(q, k_cache, v_cache, cache_len: int):
    """Plain version of kernel G: the masked fp32 decode attention."""
    return decode_attention(q, k_cache, v_cache, cache_len)


def ragged_decode_attn(q, k_cache, v_cache, cache_len: int):
    """Kernel G: one-token GQA attention over the first ``cache_len`` keys.

    Args:
        q: (Hq, 128); k_cache, v_cache: (S_view, Hk, 128), bf16 and
            contiguous on the card (a pool layer's leading rows are);
            cache_len: live keys, 1 <= cache_len <= S_view.
    Returns:
        (Hq, 128) in q's dtype.
    """
    cache_len = int(cache_len)
    _check_inputs(q, k_cache, v_cache, cache_len)
    if not _device_route("ragged_decode_attn", q):
        return ragged_decode_attn_plain(q, k_cache, v_cache, cache_len)
    hq, d = q.shape
    hk = k_cache.shape[1]
    if d != HEAD_DIM:
        raise ValueError(f"ragged_decode_attn: CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    _check_cuda("ragged_decode_attn", q, k_cache, v_cache)
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("ragged_decode_attn: CUDA kernel takes 16-byte aligned tensors")
    from ... import _build

    lib = _build.load_library()
    if hq // hk > lib.ff_ragged_decode_max_group():
        raise ValueError(f"ragged_decode_attn: {hq // hk} query heads per KV head exceed the kernel's "
                         f"{lib.ff_ragged_decode_max_group()}")
    keys_per_split, n_split = split_plan(cache_len, hk)
    out = torch.empty_like(q)
    ws_acc = torch.empty((n_split, hq, d), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((n_split, hq, 2), dtype=torch.float32, device=q.device)
    status = lib.ff_ragged_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), cache_len, hq, hk, keys_per_split, n_split, 1.0 / math.sqrt(d),
        _build.stream_ptr(q.device),
    )
    _build.check(status, "ragged_decode_attn")
    ragged_decode_attn.launches += 1
    return out


ragged_decode_attn.launches = 0


def ragged_decode_attention(q, k_cache, v_cache, cache_len):
    """One-token GQA decode attention over a ragged cache. Returns (Hq, D)."""
    return ragged_decode_attn(q, k_cache, v_cache, int(cache_len))
