"""Ragged decode attention: CUDA kernel G, its plain version, the entry point.

Counterpart of ``framefusion_tpu/ops/kernels/decode_attention.py``. Decode
after a compressed prefill attends per-layer caches of different lengths
padded into one pool; one query token attends the first ``cache_len`` keys
of its layer's (S_view, Hk, D) view, the current token included.

* ``ragged_decode_attn`` (kernel G, ``csrc/decode_attention.cu``, whose
  header says what bounds it and how the design meets that) — split-K flash
  decoding in one launch: about one wave of (n_split, Hk) CTAs over 64-key
  tiles below ``cache_len`` only, tensor-core scores and P.V, and the last
  CTA of each KV head merges the splits in split order.
* ``ragged_decode_attn_plain`` — the masked fp32 einsum of
  ``ops.attention.decode_attention`` over the whole view.

The wrapper runs the plain version when the tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
``ragged_decode_attn.launches`` counts kernel launches. ``cache_len`` is a
host int, as kernel C's layer index is. The kernel's arrival counters are one
zeroed buffer per (device, stream): the kernel leaves them at zero, and calls
on one stream never overlap.

``ragged_decode_attention`` keeps the JAX package's entry point.
"""

from __future__ import annotations

import functools
import math

import torch

from ..attention import decode_attention
from .flash_prefill import HEAD_DIM, _check_cuda, _device_route

TILE_KEYS = 64
# One wave: a CTA per SM (an H100 SXM has 132; the wrapper reads the card's
# own count). A CTA holds a 139 KB ring of K/V tiles, so one fits an SM.
SM_COUNT = 132
MAX_SPLIT = 256  # key ranges a launch may split into (the kernel's kMaxSplit)
# Arrival counters: one fixed, zeroed buffer per (device, stream), shared
# by the kernels that merge their splits in the same launch (C and G). Each
# kernel leaves its counters at zero and calls on one stream never overlap;
# a fixed size keeps a captured graph's pointer valid.
MAX_COUNTERS = 1 << 16
_COUNTERS: dict = {}


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


def split_plan(cache_len: int, hk: int, sm_count: int = SM_COUNT) -> tuple[int, int]:
    """(keys_per_split, n_split): whole 64-key tiles per CTA, as few as let
    at most one wave of ``n_split * hk <= sm_count`` CTAs cover the live
    keys; no CTA starts past the length."""
    tiles = -(-cache_len // TILE_KEYS)
    want = min(MAX_SPLIT, max(1, sm_count // hk))
    keys_per_split = -(-tiles // want) * TILE_KEYS
    return keys_per_split, -(-cache_len // keys_per_split)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device, n: int):
    """The (device, stream)'s zeroed arrival counters, of which a launch
    uses the first ``n``."""
    if n > MAX_COUNTERS:
        raise ValueError(f"a launch needs {n} arrival counters, more than the {MAX_COUNTERS} kept")
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device=device)
    return buf


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
    keys_per_split, n_split = split_plan(cache_len, hk, _sm_count(q.device.index))
    out = torch.empty_like(q)
    ws_acc = torch.empty((n_split, hq, d), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((n_split, hq, 2), dtype=torch.float32, device=q.device)
    status = lib.ff_ragged_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), _counters(q.device, hk).data_ptr(), cache_len, hq, hk, keys_per_split, n_split,
        1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(status, "ragged_decode_attn")
    ragged_decode_attn.launches += 1
    return out


ragged_decode_attn.launches = 0


def ragged_decode_attention(q, k_cache, v_cache, cache_len):
    """One-token GQA decode attention over a ragged cache. Returns (Hq, D)."""
    return ragged_decode_attn(q, k_cache, v_cache, int(cache_len))
