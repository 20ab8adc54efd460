"""Decode matvecs: CUDA kernels C and D, their plain versions, dispatchers.

Counterpart of ``framefusion_tpu/ops/kernels/matvec_q8.py``
(``csrc/matvec.cu`` says what bounds the kernels and how the design meets
it):

* ``gemv_stacked`` (kernel C) — (B <= 64, K) bf16 rows times layer ``l`` of
  one, two or three (L, K, N) weight stacks (bf16 or int8), fp32 out; the
  caller applies int8 scales. One launch: K is split over CTAs by
  ``split_plan`` and the last CTA of each column tile merges the partials
  in a fixed order, behind arrival counters kept per (device, stream). One
  row streams the weights on the CUDA cores; 2-64 rows share each weight
  tile a CTA reads, as the TPU kernel's row block does, and multiply on the
  tensor cores, so the plan and the bytes read do not grow with the rows.
  ``matvec_stacked`` and ``matvec_stacked_qkv`` keep the JAX entry points.
* ``gemv_gateup`` (kernel D) — ``silu(x@Wg*sg) * (x@Wu*su)`` over the two
  MLP stacks (``matvec_stacked_gateup``): the same pass, then an epilogue
  launch that adds the partials.
* ``matvec_q8`` / ``matvec_bf16`` keep the JAX entry points of the plain
  (K, N) matvec (``_matvec``): kernel C with the weight viewed as a one-layer
  stack, so no kernel of their own.
* ``matvec_routed`` / ``matvec_routed_gateup`` — kernels C and D over routed
  rows (the Qwen2-MoE decode): each row reads its own matrix of a stack
  viewed as (L * E, K, N), chosen by a device ``int32`` index a row
  (``index=``), so the routed experts' weights are read in place, never
  gathered. The kernel groups the rows by index on the card: a launch has
  ``min(B, L * E)`` group slots, and each distinct matrix is read once for
  all the rows that chose it. More than ``MAX_ROWS`` rows go as several
  launches (``by_row_blocks``).

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
MAX_KCHUNK = 2048  # rows of x a one-row CTA stages in shared memory (the kernel's kMaxKChunk)
TILE_BYTES = 512  # bytes of each weight row a one-row CTA reads (the kernel's kSeg)
ROWS_TILE = 256  # columns of each weight row a CTA of 2-64 rows reads (the kernel's kTileCols)
ROW_STEP = 8  # K-chunks are whole multiples of the CTA's eight warps


def _check_stacks(name, x, stacks, layer, index=None):
    if x.ndim != 2 or x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name}: x must be (B <= {MAX_ROWS}, K), got {tuple(x.shape)}")
    k = x.shape[1]
    for w in stacks:
        if w.ndim != 3 or w.shape[1] != k:
            raise ValueError(f"{name}: weight stack {tuple(w.shape)} does not match x {tuple(x.shape)}")
        if w.device != x.device:
            raise ValueError(f"{name}: inputs on several devices")
    if index is not None:
        # The values stay on the device (reading them would break a graph
        # capture): the plain version's indexing checks their range.
        if index.shape != (x.shape[0],) or index.dtype != torch.int32 or index.device != x.device:
            raise ValueError(f"{name}: index must be ({x.shape[0]},) int32 on x's device")
    elif not 0 <= layer < stacks[0].shape[0]:
        raise IndexError(f"{name}: layer {layer} out of range")


def _plain_product(x, w, layer, index=None):
    xf = x.to(torch.bfloat16).to(torch.float32)
    if index is None:
        return xf @ w[layer].to(torch.bfloat16).to(torch.float32)
    return (xf[:, None, :] @ w[index.long()].to(torch.bfloat16).to(torch.float32))[:, 0]


def column_tiles(ns, int8: bool, rows: int = 1) -> int:
    """Column tiles of the stacks' widths ``ns``: a CTA of one row reads
    ``TILE_BYTES`` of each weight row (256 bf16 or 512 int8 columns), one of
    2-64 rows ``ROWS_TILE`` columns (its accumulators, 8 a thread for each 8
    rows, keep two CTAs an SM at 256 columns)."""
    width = TILE_BYTES // (1 if int8 else 2) if rows == 1 else ROWS_TILE
    return sum(-(-n // width) for n in ns)


def split_plan(k: int, tiles: int, slots: int = 1, sm_count: int = SM_COUNT) -> tuple[int, int]:
    """(chunks, kchunk): K cut into ``chunks`` ranges of ``kchunk`` rows (a
    multiple of ``ROW_STEP``, at most ``MAX_KCHUNK``). A CTA serves all of a
    launch's rows, so the rows do not enter the plan; ``slots`` counts the
    distinct matrices a launch may read (routed rows: one a group slot). The
    fewest chunks are as many as keep the ``tiles * chunks * slots`` CTAs
    within one wave of ``CTAS_PER_SM`` an SM, or as ``MAX_KCHUNK`` forces; up
    to twice that, the count with the fewest waves per chunk wins (each
    chunk's CTAs do 1 / chunks of the work), so a plan that spills past a
    wave fills its last one; ties go to fewer chunks."""
    wave = sm_count * CTAS_PER_SM
    fewest = max(1, wave // (tiles * slots), -(-k // MAX_KCHUNK))
    chunks = min(range(fewest, 2 * fewest + 1), key=lambda c: (Fraction(-(-tiles * c * slots // wave), c), c))
    kchunk = -(-(-(-k // chunks)) // ROW_STEP) * ROW_STEP
    return -(-k // kchunk), kchunk


def _kernel_plan(x, stacks, slots: int):
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
    tiles = column_tiles([w.shape[2] for w in stacks], dtype == torch.int8, x.shape[0])
    chunks, kchunk = split_plan(x.shape[1], tiles, slots, _sm_count(x.device.index))
    return (1 if dtype == torch.int8 else 0), tiles, chunks, kchunk


def _slots(x, stack, index) -> int:
    """Group slots of a launch: one, or for routed rows one for each
    distinct matrix there may be."""
    return 1 if index is None else min(x.shape[0], stack.shape[0])


def _rows_operand(x):
    """x as the kernel reads it: at 2-64 rows the producer copies each
    row's K-values with the copy engines, which want 16-byte aligned rows,
    so rows are padded with zeros to a multiple of 8 (a copy only for a K
    off 8 or a misaligned view). Returns (x, ldx)."""
    if x.shape[0] > 1 and (x.shape[1] % 8 or x.data_ptr() % 16):
        x = torch.nn.functional.pad(x, (0, -x.shape[1] % 8))
    return x, x.shape[1]


def gemv_stacked_plain(x, stacks, layer: int, index=None):
    """Plain version of kernel C."""
    return [_plain_product(x, w, layer, index) for w in stacks]


def gemv_stacked(x, stacks, layer: int, index=None):
    """Kernel C: ``x @ w[layer]`` for each of 1-3 (L, K, N) stacks -> list of (B, N) fp32.

    ``index`` (optional, (B,) int32 on the device): row b takes ``w[index[b]]``
    in place of ``w[layer]`` (the routed rows)."""
    if not 1 <= len(stacks) <= 3:
        raise ValueError("gemv_stacked takes one to three weight stacks")
    _check_stacks("gemv_stacked", x, stacks, layer, index)
    if not _device_route("gemv_stacked", x):
        return gemv_stacked_plain(x, stacks, layer, index)
    from ... import _build

    lib = _build.load_library()
    slots = _slots(x, stacks[0], index)
    wtype, tiles, chunks, kchunk = _kernel_plan(x, stacks, slots)
    b, k = x.shape
    counters = _counters(x.device, slots * tiles)
    ns = [w.shape[2] for w in stacks]
    outs = [torch.empty((b, n), dtype=torch.float32, device=x.device) for n in ns]
    ws = torch.empty((chunks if chunks > 1 else 0, b, sum(ns)), dtype=torch.float32, device=x.device)
    pad = 3 - len(stacks)
    w_ptrs = [w.data_ptr() for w in stacks] + [None] * pad
    o_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    xr, ldx = _rows_operand(x)
    status = lib.ff_gemv_stacked(
        xr.data_ptr(), b, ldx, k, layer, stacks[0].shape[0], wtype, *w_ptrs, *(ns + [0] * pad), *o_ptrs,
        ws.data_ptr(), counters.data_ptr(), chunks, kchunk, _index_ptr(index), slots, _build.stream_ptr(x.device),
    )
    _build.check(status, "gemv_stacked")
    _count_launch(gemv_stacked)
    return outs


gemv_stacked.launches = gemv_stacked.captured = 0


def _index_ptr(index):
    return index.data_ptr() if index is not None else None


def gemv_gateup_plain(x, wg, wu, sg, su, layer: int, index=None):
    """Plain version of kernel D."""
    g = _plain_product(x, wg, layer, index)
    u = _plain_product(x, wu, layer, index)
    rows = layer if index is None else index.long()
    if sg is not None:
        g = g * sg[rows]
    if su is not None:
        u = u * su[rows]
    return torch.nn.functional.silu(g) * u


def gemv_gateup(x, wg, wu, sg, su, layer: int, index=None):
    """Kernel D: ``silu(x@wg[l] * sg[l]) * (x@wu[l] * su[l])`` -> (B, N) fp32.

    ``sg``/``su`` are (L, N) fp32 per-channel scales, or None (bf16 stacks).
    ``index`` as in ``gemv_stacked``: row b takes matrix ``index[b]`` and its
    scales.
    """
    _check_stacks("gemv_gateup", x, [wg, wu], layer, index)
    if wg.shape != wu.shape:
        raise ValueError("gemv_gateup: gate and up stacks differ in shape")
    scales = [s for s in (sg, su) if s is not None]
    for s in scales:
        if s.shape != (wg.shape[0], wg.shape[2]) or s.dtype != torch.float32 or s.device != x.device:
            raise ValueError("gemv_gateup: scales must be (L, N) fp32 on x's device")
    if not _device_route("gemv_gateup", x):
        return gemv_gateup_plain(x, wg, wu, sg, su, layer, index)
    from ... import _build

    lib = _build.load_library()
    slots = _slots(x, wg, index)
    wtype, _, chunks, kchunk = _kernel_plan(x, [wg, wu], slots)
    b, k = x.shape
    n = wg.shape[2]
    # Routed rows read their scales from the whole tables in the epilogue.
    sg_l = (sg if index is not None else sg[layer]).contiguous() if sg is not None else None
    su_l = (su if index is not None else su[layer]).contiguous() if su is not None else None
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((chunks, b, 2 * n), dtype=torch.float32, device=x.device)
    xr, ldx = _rows_operand(x)
    status = lib.ff_gemv_gateup(
        xr.data_ptr(), b, ldx, k, layer, wg.shape[0], wtype, wg.data_ptr(), wu.data_ptr(), n,
        sg_l.data_ptr() if sg_l is not None else None,
        su_l.data_ptr() if su_l is not None else None,
        out.data_ptr(), ws.data_ptr(), chunks, kchunk, _index_ptr(index), slots, _build.stream_ptr(x.device),
    )
    _build.check(status, "gemv_gateup")
    _count_launch(gemv_gateup)
    return out


gemv_gateup.launches = gemv_gateup.captured = 0


def by_row_blocks(call, *rows, block: int = MAX_ROWS):
    """``call`` over blocks of ``block`` rows of the row-aligned tensors
    ``rows`` (None passes as None), its outputs (a tensor or a tuple of
    them) joined by row; up to ``block`` rows, one call."""
    n = rows[0].shape[0]
    if n <= block:
        return call(*rows)
    outs = [call(*(None if t is None else t[i:i + block] for t in rows)) for i in range(0, n, block)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(part) for part in zip(*outs))


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


def _flat(name, w):
    """An (L, E, K, N) expert stack as the (L * E, K, N) view routed rows index."""
    if w.ndim != 4:
        raise ValueError(f"{name}: routed rows take an (L, E, K, N) stack, got {tuple(w.shape)}")
    return w.reshape(-1, *w.shape[2:])


def matvec_routed(x, w_stack, index):
    """(R, K) rows times their own matrices of an (L, E, K, N) int8/bf16
    stack: row r takes ``w_stack.view(L * E, K, N)[index[r]]`` -> (R, N) fp32
    (kernel C; ``MAX_ROWS`` rows a launch)."""
    w = _flat("matvec_routed", w_stack)
    return by_row_blocks(lambda xb, ib: gemv_stacked(xb, [w], 0, ib)[0], x, index)


def matvec_routed_gateup(x, wg_stack, wu_stack, sg, su, index):
    """``silu(x@wg*sg) * (x@wu*su)`` with each row's own expert of (L, E, K,
    N) stacks and (L, E, N) scales (or None) -> (R, N) fp32 (kernel D;
    ``MAX_ROWS`` rows a launch)."""
    wg, wu = _flat("matvec_routed_gateup", wg_stack), _flat("matvec_routed_gateup", wu_stack)
    sg = sg.reshape(-1, sg.shape[-1]) if sg is not None else None
    su = su.reshape(-1, su.shape[-1]) if su is not None else None
    return by_row_blocks(lambda xb, ib: gemv_gateup(xb, wg, wu, sg, su, 0, ib), x, index)
