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
``ragged_decode_attn.launches`` counts kernel launches (``captured``, those
recorded into a CUDA graph). ``cache_len`` is a host int, or a one-element
integer tensor on the tensors' device that the kernel reads when it runs,
as the TPU kernel reads its length scalar: a captured CUDA graph then
replays one launch at every length. A tensor length's launch is planned
(``split_plan``) for the view's rows, the largest length it may hold; a
host int's for ``cache_len`` itself. The kernel's arrival counters are one
zeroed buffer per (device, stream), or the buffer ``own_counters`` names:
the kernel leaves them at zero, and calls on one stream never overlap. A
stream being captured into a CUDA graph must have its buffer before the
capture (one eager call first, or ``own_counters``): the graph's launches
keep its address.

``ragged_decode_attention`` keeps the JAX package's entry point.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from ..attention import decode_attention
from .flash_prefill import HEAD_DIM, _check_cuda, _count_launch, _device_route

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
_OWN: list = []  # buffers named by ``own_counters``, innermost last


def _check_inputs(q, k_cache, v_cache, max_len: int) -> None:
    if q.ndim != 2 or k_cache.ndim != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(f"expected q (Hq, D), caches (S, Hk, D); got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    s_view, hk, d = k_cache.shape
    if q.shape[1] != d or q.shape[0] % hk:
        raise ValueError(f"incompatible q {tuple(q.shape)} and cache {tuple(k_cache.shape)}")
    if not 0 < max_len <= s_view:
        raise ValueError(f"cache_len must be in [1, {s_view}], got {max_len}")
    if len({q.device, k_cache.device, v_cache.device}) != 1:
        raise ValueError("inputs on several devices")


def split_plan(max_len: int, hk: int, sm_count: int = SM_COUNT) -> tuple[int, int]:
    """(keys_per_split, n_split): whole 64-key tiles per CTA, as few as let
    at most one wave of ``n_split * hk <= sm_count`` CTAs cover ``max_len``
    keys; no CTA starts past ``max_len``. At a shorter live length the
    CTAs past it find no key."""
    tiles = -(-max_len // TILE_KEYS)
    want = min(MAX_SPLIT, max(1, sm_count // hk))
    keys_per_split = -(-tiles // want) * TILE_KEYS
    return keys_per_split, -(-max_len // keys_per_split)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@contextlib.contextmanager
def own_counters(buf: torch.Tensor):
    """Within the block, launches on ``buf``'s device take ``buf`` (zeroed
    int32, ``MAX_COUNTERS`` long) as their arrival counters, whatever the
    stream: a CUDA graph captured here owns its counters, so graphs replayed
    at once on several streams never share them."""
    if buf.dtype != torch.int32 or buf.numel() != MAX_COUNTERS:
        raise ValueError(f"arrival counters are {MAX_COUNTERS} int32, got {buf.numel()} {buf.dtype}")
    _OWN.append(buf)
    try:
        yield buf
    finally:
        _OWN.pop()


def _counters(device, n: int):
    """The zeroed arrival counters of the (device, stream), or those
    ``own_counters`` names; a launch uses the first ``n``."""
    if n > MAX_COUNTERS:
        raise ValueError(f"a launch needs {n} arrival counters, more than the {MAX_COUNTERS} kept")
    if _OWN and _OWN[-1].device == device:
        return _OWN[-1]
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("arrival counters of a stream being captured must exist before the capture: "
                               "make one eager call on the capture stream first, or use own_counters")
        buf = _COUNTERS[key] = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device=device)
    return buf


def ragged_decode_attn_plain(q, k_cache, v_cache, cache_len):
    """Plain version of kernel G: the masked fp32 decode attention (an int
    or a tensor length)."""
    return decode_attention(q, k_cache, v_cache, cache_len)


def ragged_decode_attn(q, k_cache, v_cache, cache_len):
    """Kernel G: one-token GQA attention over the first ``cache_len`` keys.

    Args:
        q: (Hq, 128); k_cache, v_cache: (S_view, Hk, 128), bf16 and
            contiguous on the card (a pool layer's leading rows are);
            cache_len: live keys, 1 <= cache_len <= S_view: a host int, or
            a one-element integer tensor on q's device, read by the kernel
            when it runs (a length outside [1, S_view] gives NaN rows).
    Returns:
        (Hq, 128) in q's dtype.
    """
    on_device = isinstance(cache_len, torch.Tensor)
    if on_device:
        if cache_len.numel() != 1 or cache_len.is_floating_point():
            raise ValueError(f"a tensor cache_len must be one integer, got {tuple(cache_len.shape)} {cache_len.dtype}")
        if cache_len.device != q.device:
            raise ValueError("cache_len lies on another device than q")
        max_len = int(k_cache.shape[0])  # the launch is planned for the largest length the view holds
    else:
        cache_len = max_len = int(cache_len)
    _check_inputs(q, k_cache, v_cache, max_len)
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
    len_dev = cache_len.reshape(()).to(torch.int64) if on_device else None
    keys_per_split, n_split = split_plan(max_len, hk, _sm_count(q.device.index))
    out = torch.empty_like(q)
    ws_acc = torch.empty((n_split, hq, d), dtype=torch.float32, device=q.device)
    ws_ml = torch.empty((n_split, hq, 2), dtype=torch.float32, device=q.device)
    status = lib.ff_ragged_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), _counters(q.device, hk).data_ptr(), len_dev.data_ptr() if on_device else None, max_len,
        hq, hk, keys_per_split, n_split, 1.0 / math.sqrt(d), _build.stream_ptr(q.device),
    )
    _build.check(status, "ragged_decode_attn")
    _count_launch(ragged_decode_attn)
    return out


ragged_decode_attn.launches = ragged_decode_attn.captured = 0


def ragged_decode_attention(q, k_cache, v_cache, cache_len):
    """One-token GQA decode attention over a ragged cache (``cache_len`` an
    int or a device tensor, as ``ragged_decode_attn`` takes it). Returns (Hq, D)."""
    return ragged_decode_attn(q, k_cache, v_cache, cache_len)
