"""Decode matvecs: CUDA kernels C and D, their plain versions, dispatchers.

Counterpart of ``framefusion_tpu/ops/kernels/matvec_q8.py``
(``csrc/matvec.cu`` says what bounds the kernels and how the design meets
it):

* ``gemv_stacked`` (kernel C) — (B <= 64, K) bf16 rows times layer ``l`` of
  one, two or three (L, K, N) weight stacks (bf16 or int8), fp32 out; the
  caller applies int8 scales. ``matvec_stacked`` and ``matvec_stacked_qkv``
  keep the JAX entry points.
* ``gemv_gateup`` (kernel D) — ``silu(x@Wg*sg) * (x@Wu*su)`` over the two
  MLP stacks (``matvec_stacked_gateup``).

Like the TPU kernels, the activation row is rounded to bf16 and the weights
are read as bf16 or int8 (a float weight stack is rounded to bf16 by the
plain version, as the Pallas kernel's ``astype(bfloat16)`` does). Each
wrapper runs its plain version for CPU tensors and launches the kernel for
CUDA tensors; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .flash_prefill import _device_route

MAX_ROWS = 64
# Target CTAs per launch (about four per SM of an H100's 132).
TARGET_CTAS = 528


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


def _kernel_plan(lib, x, stacks):
    """Validate CUDA operands; return (wtype, per-stack vector width, chunks, kchunk)."""
    dtype = stacks[0].dtype
    if any(w.dtype != dtype for w in stacks) or dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"CUDA gemv takes bf16 or int8 weight stacks of one dtype, got {[w.dtype for w in stacks]}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"CUDA gemv takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or any(not w.is_contiguous() for w in stacks):
        raise ValueError("CUDA gemv takes contiguous tensors")
    vec = 16 if dtype == torch.int8 else 8
    if any(w.shape[2] % vec for w in stacks):
        raise ValueError(f"CUDA gemv needs every N to be a multiple of {vec}")
    tiles = sum(-(-w.shape[2] // (32 * vec)) for w in stacks)
    k = x.shape[1]
    chunks = max(1, min(-(-TARGET_CTAS // (tiles * x.shape[0])), -(-k // 32)))
    kchunk = -(-k // chunks)
    kchunk = -(-kchunk // 8) * 8
    kchunk = min(kchunk, lib.ff_gemv_max_kchunk())
    chunks = -(-k // kchunk)
    return (1 if dtype == torch.int8 else 0), chunks, kchunk


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
    wtype, chunks, kchunk = _kernel_plan(lib, x, stacks)
    b, k = x.shape
    ns = [w.shape[2] for w in stacks]
    outs = [torch.empty((b, n), dtype=torch.float32, device=x.device) for n in ns]
    ws = torch.empty((chunks, b, sum(ns)), dtype=torch.float32, device=x.device)
    pad = 3 - len(stacks)
    w_ptrs = [w.data_ptr() for w in stacks] + [None] * pad
    o_ptrs = [o.data_ptr() for o in outs] + [None] * pad
    status = lib.ff_gemv_stacked(
        x.data_ptr(), b, k, layer, wtype, *w_ptrs, *(ns + [0] * pad), *o_ptrs,
        ws.data_ptr(), chunks, kchunk, _build.stream_ptr(x.device),
    )
    _build.check(status, "gemv_stacked")
    gemv_stacked.launches += 1
    return outs


gemv_stacked.launches = 0


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
    wtype, chunks, kchunk = _kernel_plan(lib, x, [wg, wu])
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
    gemv_gateup.launches += 1
    return out


gemv_gateup.launches = 0


def matvec_stacked(x, w_stack, layer: int):
    """(B, K) @ w_stack[layer] -> (B, N) fp32; w_stack (L, K, N) int8 or bf16."""
    return gemv_stacked(x, [w_stack], layer)[0]


def matvec_stacked_qkv(x, wq_stack, wk_stack, wv_stack, layer: int):
    """The q, k and v matvecs over one shared row, in one launch."""
    return tuple(gemv_stacked(x, [wq_stack, wk_stack, wv_stack], layer))


def matvec_stacked_gateup(x, wg_stack, wu_stack, sg, su, layer: int):
    """silu(x @ wg * sg) * (x @ wu * su) in one launch -> (B, N) fp32."""
    return gemv_gateup(x, wg_stack, wu_stack, sg, su, layer)
