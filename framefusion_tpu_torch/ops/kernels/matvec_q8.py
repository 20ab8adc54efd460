"""Decode matvecs: CUDA kernels C and D, their plain versions, dispatchers.

Counterpart of ``framefusion_tpu/ops/kernels/matvec_q8.py``
(``csrc/matvec.cu`` says what bounds the kernels and how the design meets
it):

* ``gemv_stacked`` (kernel C) — (B <= 64, K) bf16 rows times layer ``l`` of
  one, two or three (L, K, N) weight stacks (bf16 or int8), fp32 out; the
  caller applies int8 scales. One launch: K is split over CTAs by
  ``split_plan`` and the last CTA of each column tile merges the partials
  in a fixed order, behind arrival counters kept per (device, stream).
  ``matvec_stacked`` and ``matvec_stacked_qkv`` keep the JAX entry points.
* ``gemv_gateup`` (kernel D) — ``silu(x@Wg*sg) * (x@Wu*su)`` over the two
  MLP stacks (``matvec_stacked_gateup``): the same pass, then an epilogue
  launch that adds the partials.
* ``matvec_q8`` / ``matvec_bf16`` keep the JAX entry points of the plain
  (K, N) matvec (``_matvec``): kernel C with the weight viewed as a one-layer
  stack, so no kernel of their own.

Like the TPU kernels, the activation row is rounded to bf16 and the weights
are read as bf16 or int8 (a float weight stack is rounded to bf16 by the
plain version, as the Pallas kernel's ``astype(bfloat16)`` does). Each
wrapper runs its plain version for CPU tensors and launches the kernel for
CUDA tensors; ``launches`` counts kernel launches.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from .decode_attention import SM_COUNT, _counters, _sm_count
from .flash_prefill import _count_launch, _device_route

MAX_ROWS = 64
# The plan aims for one wave of CTAS_PER_SM CTAs an SM (an H100 SXM has
# 132; the wrapper reads the card's own count): a CTA holds a 96 KB ring of
# weight rows, so two fit an SM, and their rings keep far more than the
# ~25 KB an SM needs in flight for 3.35 TB/s. One, three and four an SM
# timed slower on the card at the decode shapes.
CTAS_PER_SM = 2
MAX_KCHUNK = 2048  # rows of x a CTA stages in shared memory (the kernel's kMaxKChunk)
TILE_BYTES = 512  # bytes of each weight row a CTA reads (the kernel's kSeg)
ROW_STEP = 8  # K-chunks are whole multiples of the CTA's eight warps


def _check_stacks(name, x, stacks, layer):
    if x.ndim != 2 or x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: x must be (B <= {MAX_ROWS}, K), got {tuple(x.shape)}")
    k = x.shape[1]
    for w in stacks:
        if w.ndim != 3 or w.shape[1] != k:
            raise ValueError(f"{name}: weight stack {tuple(w.shape)} does not match x {tuple(x.shape)}")
        if w.device != x.device:
            raise ValueError(f"{name}: inputs on several devices")
    if not 0 <= layer < stacks[0].shape[0]:
        raise IndexError(f"{name}: layer {layer} out of range")


def _plain_product(x, w, layer):
    return x.to(torch.bfloat16).to(torch.float32) @ w[layer].to(torch.bfloat16).to(torch.float32)


def column_tiles(ns, int8: bool) -> int:
    """Column tiles of the stacks' widths ``ns``: a CTA reads ``TILE_BYTES``
    of each weight row (256 bf16 or 512 int8 columns)."""
    width = TILE_BYTES // (1 if int8 else 2)
    return sum(-(-n // width) for n in ns)


def split_plan(k: int, tiles: int, rows: int, sm_count: int = SM_COUNT) -> tuple[int, int]:
    """(chunks, kchunk): K cut into ``chunks`` ranges of ``kchunk`` rows (a
    multiple of ``ROW_STEP``, at most ``MAX_KCHUNK``). The fewest chunks are
    as many as keep the ``tiles * chunks * rows`` CTAs within one wave of
    ``CTAS_PER_SM`` an SM, or as ``MAX_KCHUNK`` forces; up to twice that, the
    count with the fewest waves per chunk wins (each chunk's CTAs do 1 /
    chunks of the work), so a plan that spills past a wave fills its last
    one; ties go to fewer chunks."""
    wave = sm_count * CTAS_PER_SM
    fewest = max(1, wave // (tiles * rows), -(-k // MAX_KCHUNK))
    chunks = min(range(fewest, 2 * fewest + 1), key=lambda c: (Fraction(-(-tiles * c * rows // wave), c), c))
    kchunk = -(-(-(-k // chunks)) // ROW_STEP) * ROW_STEP
    return -(-k // kchunk), kchunk


def _kernel_plan(x, stacks):
    """Validate CUDA operands; return (wtype, column tiles, chunks, kchunk)."""
    dtype = stacks[0].dtype
    if any(w.dtype != dtype for w in stacks) or dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"CUDA gemv takes bf16 or int8 weight stacks of one dtype, got {[w.dtype for w in stacks]}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"CUDA gemv takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or any(not w.is_contiguous() for w in stacks):
        raise ValueError("CUDA gemv takes contiguous tensors")
    if any(w.data_ptr() % 16 for w in stacks):
        raise ValueError("CUDA gemv takes 16-byte aligned weight stacks (16-byte loads)")
    vec = 16 if dtype == torch.int8 else 8
    if any(w.shape[2] % vec for w in stacks):
        raise ValueError(f"CUDA gemv needs every N to be a multiple of {vec}")
    tiles = column_tiles([w.shape[2] for w in stacks], dtype == torch.int8)
    chunks, kchunk = split_plan(x.shape[1], tiles, x.shape[0], _sm_count(x.device.index))
    return (1 if dtype == torch.int8 else 0), tiles, chunks, kchunk


def gemv_stacked_plain(x, stacks, layer: int):
    """Plain version of kernel C."""
    return [_plain_product(x, w, layer) for w in stacks]


def gemv_stacked(x, stacks, layer: int):
    """Kernel C: ``x @ w[layer]`` for each of 1-3 (L, K, N) stacks -> list of (B, N) fp32."""
    if not 1 <= len(stacks) <= 3:
        raise ValueError("gemv_stacked takes one to three weight stacks")
    _check_stacks("gemv_stacked", x, stacks, layer)
    if not _device_route("gemv_stacked", x):
        return gemv_stacked_plain(x, stacks, layer)
    from ... import _build

    lib = _build.load_library()
    wtype, tiles, chunks, kchunk = _kernel_plan(x, stacks)
    b, k = x.shape
    counters = _counters(x.device, b * tiles)
    ns = [w.shape[2] for w in stacks]
    outs = [torch.empty((b, n), dtype=torch.float32, device=x.device) for n in ns]
    ws = torch.empty((chunks if chunks > 1 else 0, b, sum(ns)), dtype=torch.float32, device=x.device)
    pad = 3 - len(stacks)
    w_ptrs = [w.data_ptr() for w in stacks] + [None] * pad
    o_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    status = lib.ff_gemv_stacked(
        x.data_ptr(), b, k, layer, wtype, *w_ptrs, *(ns + [0] * pad), *o_ptrs,
        ws.data_ptr(), counters.data_ptr(), chunks, kchunk, _build.stream_ptr(x.device),
    )
    _build.check(status, "gemv_stacked")
    _count_launch(gemv_stacked)
    return outs


gemv_stacked.launches = gemv_stacked.captured = 0


def gemv_gateup_plain(x, wg, wu, sg, su, layer: int):
    """Plain version of kernel D."""
    g = _plain_product(x, wg, layer)
    u = _plain_product(x, wu, layer)
    if sg is not None:
        g = g * sg[layer]
    if su is not None:
        u = u * su[layer]
    return torch.nn.functional.silu(g) * u


def gemv_gateup(x, wg, wu, sg, su, layer: int):
    """Kernel D: ``silu(x@wg[l] * sg[l]) * (x@wu[l] * su[l])`` -> (B, N) fp32.

    ``sg``/``su`` are (L, N) fp32 per-channel scales, or None (bf16 stacks).
    """
    _check_stacks("gemv_gateup", x, [wg, wu], layer)
    if wg.shape != wu.shape:
        raise ValueError("gemv_gateup: gate and up stacks differ in shape")
    scales = [s for s in (sg, su) if s is not None]
    for s in scales:
        if s.shape != (wg.shape[0], wg.shape[2]) or s.dtype != torch.float32 or s.device != x.device:
            raise ValueError("gemv_gateup: scales must be (L, N) fp32 on x's device")
    if not _device_route("gemv_gateup", x):
        return gemv_gateup_plain(x, wg, wu, sg, su, layer)
    from ... import _build

    lib = _build.load_library()
    wtype, _, chunks, kchunk = _kernel_plan(x, [wg, wu])
    b, k = x.shape
    n = wg.shape[2]
    sg_l = sg[layer].contiguous() if sg is not None else None
    su_l = su[layer].contiguous() if su is not None else None
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((chunks, b, 2 * n), dtype=torch.float32, device=x.device)
    status = lib.ff_gemv_gateup(
        x.data_ptr(), b, k, layer, wtype, wg.data_ptr(), wu.data_ptr(), n,
        sg_l.data_ptr() if sg_l is not None else None,
        su_l.data_ptr() if su_l is not None else None,
        out.data_ptr(), ws.data_ptr(), chunks, kchunk, _build.stream_ptr(x.device),
    )
    _build.check(status, "gemv_gateup")
    _count_launch(gemv_gateup)
    return out


gemv_gateup.launches = gemv_gateup.captured = 0


def matvec_stacked(x, w_stack, layer: int):
    """(B, K) @ w_stack[layer] -> (B, N) fp32; w_stack (L, K, N) int8 or bf16."""
    return gemv_stacked(x, [w_stack], layer)[0]


def matvec_stacked_qkv(x, wq_stack, wk_stack, wv_stack, layer: int):
    """The q, k and v matvecs over one shared row, in one launch."""
    return tuple(gemv_stacked(x, [wq_stack, wk_stack, wv_stack], layer))


def matvec_stacked_gateup(x, wg_stack, wu_stack, sg, su, layer: int):
    """silu(x @ wg * sg) * (x @ wu * su) in one launch -> (B, N) fp32."""
    return gemv_gateup(x, wg_stack, wu_stack, sg, su, layer)


def _one_layer(name, w):
    if w.ndim != 2:
        raise ValueError(f"{name}: w must be (K, N), got {tuple(w.shape)}")
    return w[None]


def matvec_q8(x, w8, scale):
    """(B, K) bf16 @ (K, N) int8 -> (B, N) fp32, times the per-column fp32
    ``scale`` (N,); on the card N must be a multiple of 16."""
    return matvec_stacked(x, _one_layer("matvec_q8", w8), 0) * scale


def matvec_bf16(x, w):
    """(B, K) bf16 @ (K, N) bf16 -> (B, N) fp32; on the card N must be a
    multiple of 8."""
    return matvec_stacked(x, _one_layer("matvec_bf16", w), 0)
