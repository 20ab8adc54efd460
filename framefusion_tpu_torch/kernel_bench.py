"""On-card kernel check and benchmarks of the port.

Counterpart of ``scripts/kernel_bench.py`` in all of its modes; run from the
repository root on a machine with a CUDA card:

    python -m framefusion_tpu_torch.kernel_bench --check
    python -m framefusion_tpu_torch.kernel_bench --batch-parity
    python -m framefusion_tpu_torch.kernel_bench --what {attn,quant,decode,engine,ledger,decodestep,all}

``--check`` (:func:`check_kernels`) runs the JAX check's case matrix on the
card: every hand-written kernel at each shape regime the TPU kernels had
(the per-query-head, grouped, blocked and long attention regimes, the fused
importance epilogues, the sink, bidirectional and ragged decode kernels, the
matvecs at Qwen2-7B shapes), each held against the port's own plain version
with the bound stated below, then the decode-side programs of
``models/qwen2.py`` against each other on a 2-layer Qwen2-7B-geometry stack.
It prints PASS or FAIL per row and the number of failures, and exits
non-zero on any failure.

``--batch-parity`` (:func:`check_batch_parity`) holds the lockstep-batched
planned prefill's decisions against the solo prefills' on three 16-frame
prompts at Qwen2-7B width (8 layers), and reports the batched decode's
greedy agreement with the solo decodes.

``--what decodestep`` (:func:`bench_decodestep`) times ``decode_step`` at
full Qwen2-7B width (int8 weight-only, full vocabulary) with CUDA events over
32 steps for ``"einsum"``, ``"flash"`` and ``"ragged"``, in turns, on three
pools: a uniform one (S 3,328), the per-layer caches of a FrameFusion
prefill of the 64-frame prompt, and the JAX bench's stand-in for it (two
layers of 11,697 keys, the rest 3,292, S_pool 11,776), the last two with
and without ``best_tail_split``; beside the times, the weight-stream floor
and the CUDA launches per step (``torch.profiler``). The same pools also
run as a captured CUDA graph of the step (``runtime/decode_graph.py``,
rows ``graph-ragged``, the engine's decode, and ``graph-flash``): replays
timed between CUDA events, with the kernel launches the graph holds.

The other ``--what`` modes print one row a measurement, its time beside
the least time the card could take (``bound_ms``: bytes over 3.35 TB/s or
operations over the peak rate of their type, whichever is larger). A row
that launches a kernel of the port is first held against a reference on
the same inputs (``err`` against ``tol``); a mode exits non-zero when one
is off:

* ``attn`` (:func:`bench_attention`): kernel A at S 3,328-23,552 (28 / 4
  heads of 128, bf16, causal) against causal SDPA, its output held
  against SDPA's.
* ``quant`` (:func:`bench_quant`): at (3,328 x 3,584) . (3,584 x 18,944),
  bf16 ``torch.matmul`` against int8 x int8 -> int32 (``torch._int_mm``,
  which ``qwen2._int8_matmul`` calls), the W8A8 epilogue and the W8A8
  ``qwen2.mm`` with its activation quantization: library calls, measured to
  answer whether a W8A8 prefill tail would pay.
* ``decode`` (:func:`bench_decode`): kernels C and D at Qwen2-7B's decode
  shapes, int8 and bf16, over 8-layer stacks (each call reads another
  layer, so the weights come from memory, not L2), with effective GB/s,
  each stack held against the plain version; then the stacked MLP chain the decode graph runs (D then C, layer after
  layer) and a read of the same stacks by ``torch.sum``.
* ``engine`` (:func:`bench_engine`): the fused, planned (one- and
  two-stage), segmented and dense prefill of the 64-frame, 11,697-token
  prompt at Qwen2-7B width (vocabulary cut to 8,192, as the JAX bench's),
  each beside the GEMM-and-attention floor of the rows its events kept and
  each compressed one held against the fused prefill (events and logits);
  the planned prefill split into its stages (the tail's logits held
  against a whole planned prefill at the same buckets); the pre-event
  merge alone, the tail at S 3,328, the cache pack, and 32 greedy decode
  tokens solo and batched. The JAX mode also compares XLA's loop forms of the tail (scan,
  fori, unrolled); they have no counterpart here, so the port's own tail
  is timed once.
* ``ledger`` (:func:`bench_ledger`): the planned prefill's stages
  (pre-event merge and compaction, phase, compaction, tail, cache pack)
  each timed alone at the JAX ledger's buckets (pre-plan 6,528, plan
  3,328), each beside its floor.
* ``all``: the five above on one model.

All need a CUDA device and exit non-zero at once without one.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

# Bounds, with their reasons:
# * Attention kernels (A, E, F) round their probabilities to bf16 for the
#   P.V product and write bf16 outputs; G rounds only its output. Each
#   (row, head) output agrees with the plain fp32 version to a few bf16 ulps
#   (2^-8..2^-7 relative) of that row's own largest output.
ATTN_ROW_RTOL = 2e-2
# * Kernel B's importance from A's fp32 row statistics against the plain
#   fp32 softmax einsum: fp32 sums in other orders, relative to the largest
#   importance.
IMP_RTOL = 1e-3
# * Kernel C/D's fp32 sums of bf16 x bf16/int8 products in another order:
#   fp32 rounding over K <= 18944 terms, relative to the largest output.
GEMV_RTOL = 1e-4
# * Two decode-side programs on the same stack: the logits are bf16
#   products (an ulp is 2^-8..2^-7 of the largest), and the programs round
#   every projection at other places (cuBLAS against kernels C/D, fp32
#   against split-K attention). On the CPU this check's geometry gives
#   6.8e-3 (bf16) and 1.1e-2 (int8) of the largest logit; 3e-2 is about four
#   ulps of it.
PROGRAM_RTOL = 3e-2
# * The benchmark modes' prefills against the fused prefill of the same
#   prompt on the same weights: bf16 runs that round elsewhere (kernel A at
#   other padded lengths and masks, other GEMM shapes), so two roundings
#   of one 28-layer model, as ``chip_smoke.py``'s LOGIT_RTOL reasons.
ENGINE_RTOL = 6e-2

HD = 128
# Peaks of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
H100_BYTES_PER_S = 3.35e12
H100_BF16_OPS_PER_S = 989e12
H100_INT8_OPS_PER_S = 1979e12


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; the kernel check and the decode benchmark run on the card only",
              file=sys.stderr)
        raise SystemExit(1)


def _rand(gen, shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = H100_BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes the
    function must move (inputs read once, outputs written once) over the
    memory rate and its operations over the peak rate of their type (the
    bf16 tensor-core rate unless given); and which of the two it is."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def events_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn()`` over eager launches, by CUDA events
    (``runtime.profiling.elapsed``; for calls that keep the card busy for
    milliseconds)."""
    from .runtime.profiling import elapsed

    for _ in range(warmup):
        fn()
    return elapsed(fn, True, iters)[0] * 1e3


def graph_time_ms(fn, iters: int) -> float:
    """Device time per call of ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events. A wrapper call costs the host
    tens of microseconds (checks, allocations, the ctypes call), more than a
    short kernel runs, so eager launches would time the host; the replay
    times the card."""
    from .runtime.decode_graph import capture_graph

    graph = capture_graph(lambda: [fn() for _ in range(iters)], torch.cuda.current_device(), warmup=fn)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_us(fn, names, reps: int = 20) -> dict:
    """Device time per call of each named CUDA kernel ``fn()`` launches,
    from a ``torch.profiler`` trace of ``reps`` calls (the kernels' own
    intervals, launch gaps excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    for e in prof.events():
        for name in names:
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
                total[name] += e.time_range.elapsed_us() / reps
    return total


def device_profile(fn) -> dict:
    """One call of ``fn()`` under ``torch.profiler``: the device window
    (first device operation's start to the last one's end), the time the
    device was busy in it (the union of the operations' intervals), the
    idle share of the window, the device operations (kernels, copies,
    sets) and the device time by kernel name, in microseconds. Empty
    counts where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # A range a ``record_function`` opens (``Optimizer.step``, say) shows on
    # the device timeline too; it is no device operation.
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    by_name: dict = {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return dict(window_us=window, busy_us=busy, idle_share=(1.0 - busy / window) if window else None,
                launches=len(spans), by_name=by_name)


def sdpa(q, k, v, mask=None, is_causal: bool = False):
    """One ``F.scaled_dot_product_attention`` call on (S, H, D) or (B, S, H,
    D) tensors, GQA through ``enable_gqa``, an optional bool mask: the
    yardstick of the attention kernels (timed only; the port never calls
    it). Inputs go in as (B, H, S, D): the fused backends take 4-D only."""
    q, k, v = (t.transpose(-3, -2) if t.dim() == 4 else t.transpose(0, 1)[None] for t in (q, k, v))
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                                            enable_gqa=q.shape[1] != k.shape[1])


def _log_times(log, name, t_k, t_p, t_l, nbytes, ops) -> None:
    b, by = bound_ms(nbytes, ops)
    lib = "none" if t_l is None else f"{t_l:.4f}"
    log(f"  time  {name:58s} kernel {t_k:.4f} ms, plain {t_p:.4f}, library {lib}, bound {b:.4f} ({by})")


def row_rel_err(out, ref) -> float:
    """Largest (row, head) error over that row's largest |ref| (last axis);
    rows that are 0 in both give 0."""
    err = (out.float() - ref.float()).abs().amax(-1)
    return (err / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()


def rel_err(out, ref) -> float:
    """Largest error over the largest |ref|."""
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


class _Rows:
    """Runs check rows: each returns (error, bound); prints PASS/FAIL."""

    def __init__(self, log):
        self.log = log
        self.failures: list[str] = []
        self.count = 0

    def run(self, name: str, fn) -> None:
        self.count += 1
        try:
            err, bound = fn()
            torch.cuda.synchronize()
            ok = math.isfinite(err) and err <= bound
            self.log(f"  {'PASS' if ok else 'FAIL'}  {name:58s} rel err {err:.3e} <= {bound:.0e}")
        except Exception as exc:  # a launch or shape failure is a failed row
            ok = False
            self.log(f"  FAIL  {name:58s} {type(exc).__name__}: {str(exc)[:160]}")
        if not ok:
            self.failures.append(name)


def _time_attention(log, name, q, k, v, kernel, plain) -> None:
    """Kernel A's time at a regime shape beside its plain version, the causal
    library call and the bound (causal pairs, every key live)."""
    s, hq, _ = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * hq * s * 4  # q, k, v in; out, m, l out
    _log_times(log, name, events_time_ms(kernel, 5), events_time_ms(plain, 2, warmup=1),
               events_time_ms(lambda: sdpa(q, k, v, is_causal=True), 5), nbytes, 4 * hq * HD * s * (s + 1) / 2)


def _check_attention(rows: _Rows, gen) -> None:
    from .ops.attention import last_rows_importance
    from .ops.kernels import bidir_attention as ba
    from .ops.kernels import decode_attention as da
    from .ops.kernels import flash_prefill as fp
    from .ops.kernels import sink_prefill as sp

    def qkv(s, hq, hk):
        return _rand(gen, (s, hq, HD)), _rand(gen, (s, hk, HD)), _rand(gen, (s, hk, HD))

    # The TPU kernel's dispatch regimes at Qwen2-7B head geometry; on the
    # card kernel A covers all of them.
    regimes = [
        ("gmulti bq=512 (S<=4096)", 3456, 28, 4),
        ("gmulti bq=1024 (4096<S<=8192)", 6656, 28, 4),
        ("blocked-grouped MID (8192<S<=16384)", 11776, 28, 4),
        ("per-qhead resident (g=1)", 3456, 4, 4),
        ("blocked long (g=1, S>16384)", 18432, 2, 2),
        ("blocked-grouped long (S>16384)", 18432, 28, 4),
    ]
    for name, s, hq, hk in regimes:
        q, k, v = qkv(s, hq, hk)
        kv = torch.rand((s,), generator=gen, device="cuda") > 0.3
        kv[0] = True
        for label, mask in (("", None), (" +key_valid", kv)):
            rows.run(f"A {name}{label}", lambda q=q, k=k, v=v, m=mask: (
                row_rel_err(fp.flash_attn_fwd(q, k, v, m)[0], fp.flash_attn_fwd_plain(q, k, v, m)[0]),
                ATTN_ROW_RTOL))
        _time_attention(rows.log, f"A {name}", q, k, v, lambda q=q, k=k, v=v: fp.flash_attn_fwd(q, k, v),
                        lambda q=q, k=k, v=v: fp.flash_attn_fwd_plain(q, k, v))
        del q, k, v

    # The TPU package's plain grouped kernel, called directly with an
    # all-valid mask: kernel A with an all-true key_valid.
    q, k, v = qkv(3456, 28, 4)
    ones = torch.ones((3456,), dtype=torch.bool, device="cuda")
    rows.run("A grouped (direct, all-valid mask)", lambda: (
        row_rel_err(fp.flash_attn_fwd(q, k, v, ones)[0], fp.flash_attn_fwd_plain(q, k, v)[0]), ATTN_ROW_RTOL))
    _time_attention(rows.log, "A grouped (direct, all-valid mask)", q, k, v,
                    lambda: fp.flash_attn_fwd(q, k, v, ones), lambda: fp.flash_attn_fwd_plain(q, k, v, ones))

    # The importance epilogues (A + B), num 4 (Qwen2-VL's capture rows),
    # compacted and mask-only; S 7,168 is the bucket of Qwen2-VL-7B's
    # 7,072-token 64-frame video prompt.
    for name, s, hq, hk in (("gmulti (S<=8192)", 3456, 28, 4), ("per-qhead fused (g=1)", 3456, 4, 4),
                            ("MID blkgrp", 11776, 28, 4), ("Qwen2-VL prompt bucket", 7168, 28, 4)):
        q, k, v = qkv(s, hq, hk)
        vlen = s - 40
        kv = torch.arange(s, device="cuda") < vlen
        kv[100:140] = False
        for label, mask in (("", None), (" +key_valid", kv)):
            def pair(q=q, k=k, v=v, m=mask):
                return fp.flash_causal_attention_importance(q, k, v, vlen, 4, key_valid=m)

            rows.run(f"A+B imp {name}{label} [out]", lambda q=q, k=k, v=v, m=mask, pair=pair: (
                row_rel_err(pair()[0][:vlen], fp.flash_attn_fwd_plain(q, k, v, m)[0][:vlen]), ATTN_ROW_RTOL))
            rows.run(f"A+B imp {name}{label} [imp]", lambda q=q, k=k, m=mask, pair=pair: (
                rel_err(pair()[1], last_rows_importance(q, k, 4, vlen, key_valid=m)), IMP_RTOL))
        del q, k, v

    q, k, v = qkv(3456, 28, 4)
    rows.run("F sink (S 3456, init 8, window 1024)", lambda: (
        row_rel_err(sp.sink_attn_fwd(q, k, v, 8, 1024), sp.sink_attn_fwd_plain(q, k, v, 8, 1024)), ATTN_ROW_RTOL))
    del q, k, v

    # SigLIP-so400m's frame batch, a 64-dim tower, and the Qwen2-VL-7B
    # tower's (32 temporal frames of 26 x 34 patches, 16 heads of 80).
    for b, n, h, d in ((4, 729, 16, 72), (2, 1025, 16, 64), (32, 884, 16, 80)):
        q4, k4, v4 = (_rand(gen, (b, n, h, d)) for _ in range(3))
        rows.run(f"E bidir ({b}, {n}, {h}, {d})", lambda q4=q4, k4=k4, v4=v4, d=d: (
            row_rel_err(ba.flash_bidir_attention(q4, k4, v4), ba.bidir_attn_fwd_plain(q4, k4, v4, d ** -0.5)),
            ATTN_ROW_RTOL))

    qd, kp, vp = _rand(gen, (28, HD)), _rand(gen, (2048, 4, HD)), _rand(gen, (2048, 4, HD))
    rows.run("G ragged decode (28/4 heads, S 2048, length 1700)", lambda: (
        row_rel_err(da.ragged_decode_attention(qd, kp, vp, 1700), da.ragged_decode_attn_plain(qd, kp, vp, 1700)),
        ATTN_ROW_RTOL))


def _check_matvecs(rows: _Rows, gen) -> None:
    from .ops.kernels import matvec_q8 as mv

    kdim, n = 3584, 4608
    x = _rand(gen, (1, kdim), 0.1)
    w8 = torch.randint(-127, 128, (kdim, n), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 0.005
    rows.run("matvec_q8 1x3584 . 3584x4608 (C, one layer)", lambda: (
        rel_err(mv.matvec_q8(x, w8, sc), mv.gemv_stacked_plain(x, [w8[None]], 0)[0] * sc), GEMV_RTOL))
    wbf = (w8.to(torch.bfloat16) * sc).to(torch.bfloat16)
    rows.run("matvec_bf16 1x3584 . 3584x4608 (C, one layer)", lambda: (
        rel_err(mv.matvec_bf16(x, wbf), mv.gemv_stacked_plain(x, [wbf[None]], 0)[0]), GEMV_RTOL))
    # Times of one (L2-resident) weight, from CUDA-graph replays.
    nbytes = kdim * 2 + n * 4  # the row in, the fp32 result out
    _log_times(rows.log, "matvec_q8 1x3584 . 3584x4608 (C, one layer)",
               graph_time_ms(lambda: mv.matvec_q8(x, w8, sc), 20),
               graph_time_ms(lambda: mv.gemv_stacked_plain(x, [w8[None]], 0)[0] * sc, 20), None,
               nbytes + kdim * n + n * 4, 2 * kdim * n)
    _log_times(rows.log, "matvec_bf16 1x3584 . 3584x4608 (C, one layer)",
               graph_time_ms(lambda: mv.matvec_bf16(x, wbf), 20),
               graph_time_ms(lambda: mv.gemv_stacked_plain(x, [wbf[None]], 0)[0], 20),
               graph_time_ms(lambda: torch.matmul(x, wbf), 20), nbytes + kdim * n * 2, 2 * kdim * n)
    ws = torch.stack([w8, -w8])
    rows.run("matvec stacked l=1", lambda: (
        rel_err(mv.matvec_stacked(x, ws, 1), mv.gemv_stacked_plain(x, [ws], 1)[0]), GEMV_RTOL))
    xb = _rand(gen, (4, kdim), 0.1)
    rows.run("matvec stacked rows=4", lambda: (
        rel_err(mv.matvec_stacked(xb, ws, 0), mv.gemv_stacked_plain(xb, [ws], 0)[0]), GEMV_RTOL))
    del w8, wbf, ws

    # The fused decode kernels at Qwen2-7B shapes.
    def q8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    wq, wk, wv = q8((2, 3584, 3584)), q8((2, 3584, 512)), q8((2, 3584, 512))
    for i, part in ((0, "q"), (2, "v")):
        rows.run(f"matvec qkv fused int8 l=1 [{part}]", lambda i=i: (
            rel_err(mv.matvec_stacked_qkv(x, wq, wk, wv, 1)[i], mv.gemv_stacked_plain(x, [wq, wk, wv], 1)[i]),
            GEMV_RTOL))
    del wq, wk, wv
    wg, wu = q8((2, 3584, 18944)), q8((2, 3584, 18944))
    sg = torch.rand((2, 18944), generator=gen, device="cuda") * 0.01 + 0.005
    su = torch.rand((2, 18944), generator=gen, device="cuda") * 0.01 + 0.005
    rows.run("matvec gateup fused int8 l=1", lambda: (
        rel_err(mv.matvec_stacked_gateup(x, wg, wu, sg, su, 1), mv.gemv_gateup_plain(x, wg, wu, sg, su, 1)),
        GEMV_RTOL))
    wgb, wub = (wg.to(torch.bfloat16) * 0.01), (wu.to(torch.bfloat16) * 0.01)
    rows.run("matvec gateup fused bf16 l=0", lambda: (
        rel_err(mv.matvec_stacked_gateup(x, wgb, wub, None, None, 0), mv.gemv_gateup_plain(x, wgb, wub, None, None, 0)),
        GEMV_RTOL))


def _check_programs(rows: _Rows, gen) -> None:
    from .config import qwen2_7b_config
    from .models import qwen2
    from .ops.quant import quantize_params_int8

    cfg = qwen2_7b_config(vocab_size=8192, num_layers=2)
    hk, d = cfg.num_kv_heads, cfg.hidden_size

    def pools(*lead):
        return _rand(gen, (*lead, 512, hk, HD), 0.1), _rand(gen, (*lead, 512, hk, HD), 0.1)

    def step(prm, emb, kp, vp, lens, impl):
        return qwen2.decode_step(prm, emb, 400, kp.clone(), vp.clone(), lens, cfg, attn_impl=impl)[0]

    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(3))
    for tag in ("bf16", "int8"):
        if tag == "int8":
            params = quantize_params_int8(params)  # in place: the bf16 rows ran first
        emb = _rand(gen, (d,), 0.1)
        kp, vp = pools(2)
        lens = [400, 380]
        for impl in ("ragged", "flash"):
            rows.run(f"decode_step {impl} == einsum, {tag} [logits]",
                     lambda prm=params, emb=emb, kp=kp, vp=vp, impl=impl: (
                         rel_err(step(prm, emb, kp, vp, lens, impl), step(prm, emb, kp, vp, lens, "einsum")),
                         PROGRAM_RTOL))
        embs = _rand(gen, (3, d), 0.1)
        kpb, vpb = pools(2, 3)
        lensb = [[300, 260, 200], [280, 240, 190]]
        posb = [300, 260, 200]

        def batch(impl, prm=params, embs=embs, kpb=kpb, vpb=vpb):
            return qwen2.decode_step_batch(prm, embs, posb, kpb.clone(), vpb.clone(), lensb, 440, 2, cfg,
                                           attn_impl=impl)[0]

        rows.run(f"decode_step_batch flash == einsum, {tag} [logits]", lambda batch=batch: (
            rel_err(batch("flash"), batch("einsum")), PROGRAM_RTOL))

    # Speculative verify: the K-row program against K sequential decode
    # steps fed the same rows, and the batched program against per-sequence
    # solo programs. Fresh weights: the int8 rows consumed the bf16 ones.
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(4))
    kq = 4
    rows_emb = _rand(gen, (kq, d), 0.1)
    kp0, vp0 = pools(2)
    lens0 = [400, 380]
    for impl in ("flash", "einsum"):
        def sequential(impl=impl):
            kp, vp, lens, out = kp0.clone(), vp0.clone(), lens0, []
            for i in range(kq):
                lg, kp, vp, lens = qwen2.decode_step(params, rows_emb[i], 400 + i, kp, vp, lens, cfg, attn_impl=impl)
                out.append(lg)
            return torch.stack(out)

        rows.run(f"verify_step K=4 == sequential decode, {impl} [logits]", lambda impl=impl, seq=sequential: (
            rel_err(qwen2.verify_step(params, rows_emb, [400 + i for i in range(kq)], kp0.clone(), vp0.clone(),
                                      lens0, cfg, attn_impl=impl)[0], seq()), PROGRAM_RTOL))
    bsz = 3
    embsk = _rand(gen, (bsz, kq, d), 0.1)
    kpbk, vpbk = pools(2, bsz)
    lensbk = [[300, 260, 200], [280, 240, 190]]
    posbk = [[lensbk[0][b] + i for i in range(kq)] for b in range(bsz)]

    def solo_rows():
        return torch.stack([qwen2.verify_step(params, embsk[b], posbk[b], kpbk[:, b].clone(), vpbk[:, b].clone(),
                                              [lensbk[0][b], lensbk[1][b]], cfg)[0] for b in range(bsz)])

    rows.run("verify_step_batch B=3 == per-seq solo [logits]", lambda: (
        rel_err(qwen2.verify_step_batch(params, embsk, posbk, kpbk.clone(), vpbk.clone(), lensbk,
                                        torch.zeros((bsz, 512), dtype=torch.bool, device="cuda"), 440, 0, cfg)[0],
                solo_rows()), PROGRAM_RTOL))


def check_kernels(log=print) -> int:
    """Run every check row on the card; returns the number of failures."""
    _require_cuda()
    rows = _Rows(log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in (_check_attention, _check_matvecs, _check_programs):
        part(rows, gen)
        torch.cuda.empty_cache()
    log(f"\n{len(rows.failures)} failures of {rows.count} rows" + (f": {rows.failures}" if rows.failures else ""))
    return len(rows.failures)


def check_batch_parity(log=print) -> int:
    """On-card check that the lockstep-batched planned prefill decides as
    the solo prefills do (the counterpart of the JAX script's
    ``check_batch_parity``): Qwen2-7B heads and hidden size, 8 layers, vocab
    8,192, three 16-frame x 182-patch prompts at coherence 0.35 / 0.45 /
    0.55. The batch runs its (B, S, D) GEMMs where the solo runs (S, D)
    ones, so a similarity or budget tie could flip a decision; the CPU
    suite pins exact parity with the plain versions, this check the
    kernels' path at real widths. Gated: the solo planned prefill at
    PlanHistory's buckets decides as the solo fused one, and the batch at
    the same buckets as the solo planned ones. Reported only: how many
    greedy tokens of the batched decode agree with each solo decode (bf16
    argmax ties are legitimate). Returns the number of failures."""
    _require_cuda()
    from .config import FrameFusionConfig, qwen2_7b_config
    from .models import qwen2
    from .models.adapters.common import build_video_prompt
    from .runtime.engine import CompressionEngine, PlanHistory

    cfg = qwen2_7b_config(vocab_size=8192, num_layers=8)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1, schedule_num_layers=8)
    engine = CompressionEngine(qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg, ff)
    rng = np.random.default_rng(7)
    patch_num, n_frames = 182, 16
    prompts = []
    for c in (0.35, 0.45, 0.55):
        h, pt, img_start, n_img = build_video_prompt(rng, cfg.hidden_size, n_frames=n_frames, patch_num=patch_num,
                                                     coherent=c)
        prompts.append((torch.from_numpy(h).to("cuda", cfg.dtype), pt, np.arange(len(pt)), img_start, n_img))
    failures = []

    def ev(res):
        return [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]

    def gate(ok, name, what):
        log(f"  {'PASS' if ok else 'FAIL'}  {what}")
        if not ok:
            failures.append(name)

    solo_fused = [engine.prefill(h, pt, pos, patch_num, i0, il) for (h, pt, pos, i0, il) in prompts]
    pre_plan, plan = engine.plan_history.suggest(PlanHistory.key(patch_num, n_frames, ff), ff.bucket)
    log(f"  history buckets: pre_plan={pre_plan} plan={plan}")
    solo_planned = [engine.prefill_planned(h, pt, pos, patch_num, i0, il, plan_len=plan, pre_plan_len=pre_plan)
                    for (h, pt, pos, i0, il) in prompts]
    for i, (f_res, p_res) in enumerate(zip(solo_fused, solo_planned)):
        gate(ev(f_res) == ev(p_res) and f_res.valid_len == p_res.valid_len and p_res.mode == "planned",
             f"solo-planned-seq{i}", f"solo planned == fused   seq{i} events={ev(p_res)} n={p_res.valid_len} "
             f"mode={p_res.mode}")
    batched = engine.prefill_planned_batch(prompts, patch_num=patch_num, plan_len=plan, pre_plan_len=pre_plan)
    for i, (s_res, b_res) in enumerate(zip(solo_planned, batched)):
        gate(ev(s_res) == ev(b_res) and s_res.valid_len == b_res.valid_len
             and [c[2] for c in s_res.layer_caches] == [c[2] for c in b_res.layer_caches],
             f"batch-decisions-seq{i}", f"batch == solo decisions seq{i} events={ev(b_res)} n={b_res.valid_len} "
             f"mode={b_res.mode}")
    n_new = 8
    batch_toks = engine.generate_batch(batched, n_new)
    for i, s_res in enumerate(solo_planned):
        solo_toks = engine.generate(s_res, n_new)
        m = next((j for j, (a, b) in enumerate(zip(solo_toks, batch_toks[i])) if a != b), n_new)
        log(f"  INFO  batched-decode greedy match seq{i}: {m}/{n_new}")
    log(f"\n{len(failures)} failures" + (f": {failures}" if failures else ""))
    return len(failures)


# ---------------------------------------------------------------------------
# --what decodestep


def device_launches(fn) -> int:
    """CUDA kernels and memory operations ``fn()`` puts on the card, counted
    from a ``torch.profiler`` trace (0 where the profiler sees no device)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def weight_stream_bytes(params: dict) -> int:
    """Bytes one decode step must read: every layer tensor, the final norm
    and the LM head (the embedding table contributes one row)."""
    def nbytes(t):
        return sum(nbytes(v) for v in t.values()) if isinstance(t, dict) else t.numel() * t.element_size()

    head = params.get("lm_head", params["embed"])
    return nbytes(params["layers"]) + nbytes(params["final_norm"]) + nbytes(head)


def decode_loop(params, cfg, k_pool, v_pool, lens, pos0: int, steps: int, attn_impl: str, tail_split=None,
                tok0=17) -> list:
    """``steps`` greedy eager decode steps from token ``tok0`` (an int or a
    device scalar), host-int positions and lengths; the pools are written in
    place. Returns the tokens, ``tok0`` first, as device scalars."""
    from .models import qwen2

    toks = [torch.as_tensor(tok0, device=k_pool.device)]
    for i in range(steps):
        logits, k_pool, v_pool, lens = qwen2.decode_step(params, qwen2.embed(params, toks[-1]), pos0 + i, k_pool,
                                                         v_pool, lens, cfg, attn_impl=attn_impl, tail_split=tail_split)
        toks.append(torch.argmax(logits))
    return toks


def generate_eager(engine, result, max_new_tokens: int) -> list:
    """Greedy decode as the engine ran it before its decode became a CUDA
    graph: ``decode_loop`` over the engine's pool, from the prefill's token,
    with ``engine.attn_impl``'s decode ("flash": kernels C and D, plain
    attention). Kept to time against the graph."""
    from .runtime.engine import best_tail_split

    k_pool, v_pool, lens = engine.make_decode_state(result, max_new_tokens)
    split = best_tail_split(lens, int(k_pool.shape[1]), max_new_tokens, engine.ff.bucket)
    toks = decode_loop(engine.params, engine.cfg, k_pool, v_pool, lens, result.decode_pos_base, max_new_tokens - 1,
                       engine.attn_impl, split, tok0=torch.argmax(result.logits))
    return [int(t) for t in torch.stack(toks).tolist()]


def decode_graph_on(params, cfg, k_pool, v_pool, lens, pos0: int, steps: int, attn_impl: str, tail_split=None,
                    tok0: int = 17):
    """A greedy ``DecodeGraph`` over copies of the given pools, started at
    ``tok0`` (as ``decode_loop`` starts), with room for ``steps`` steps."""
    from .ops.sampling import SamplerConfig
    from .runtime.decode_graph import DecodeGraph, slots_for

    graph = DecodeGraph(params, cfg, int(k_pool.shape[1]), attn_impl=attn_impl, tail_split=tail_split,
                        sampler=SamplerConfig(), n_slots=slots_for(steps + 1))
    graph.k_pool.copy_(k_pool)
    graph.v_pool.copy_(v_pool)
    first = torch.zeros(cfg.vocab_size, dtype=torch.float32, device=k_pool.device)
    first[tok0] = 1.0
    graph.start(lens, pos0, first)
    return graph, first


def _main_prompt_prefill(cfg, log):
    """Random Qwen2-7B weights (bf16, seed 0) and the FrameFusion fused
    prefill of the 64-frame prompt (cost 0.3, S_th 0.6, r_min 0.1)."""
    from .interface import FrameFusionModel, apply_framefusion
    from .models import qwen2
    from .models.adapters.common import build_video_prompt

    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), 0.3, 0.6, 0.1)
    res = model.engine().prefill(torch.from_numpy(h).to("cuda", torch.bfloat16), pt, np.arange(len(pt)), 182,
                                 img_start, n_img)
    log(f"  FrameFusion prefill of the {len(pt)}-token prompt: {res.valid_len} tokens kept")
    return params, res


def bench_decodestep(params=None, cfg=None, prefill=None, steps: int = 32, log=print) -> dict:
    """ms/step of ``decode_step`` per (geometry, attn_impl, split), the
    weight-stream floor and the CUDA launches per step.

    ``params`` (int8 weight-only), ``cfg`` and ``prefill`` (a FrameFusion
    ``PrefillResult`` of the 64-frame prompt) may come from the caller;
    without them the function builds random Qwen2-7B weights, runs the
    prefill and quantizes. Returns {"floor_ms", "rows": [{geometry, impl,
    split, ms_per_step, launches_per_step}]}; the graph rows' impl is
    "graph-ragged" or "graph-flash"."""
    _require_cuda()
    from .config import FrameFusionConfig, qwen2_7b_config
    from .ops.quant import quantize_params_int8
    from .runtime.engine import CompressionEngine, best_tail_split

    if params is None:
        cfg = qwen2_7b_config()
        params, prefill = _main_prompt_prefill(cfg, log)
        params = quantize_params_int8(params)
    floor_ms = weight_stream_bytes(params) / H100_BYTES_PER_S * 1e3
    log(f"  weights read per step: {weight_stream_bytes(params) / 2**30:.2f} GiB -> weight-stream floor "
        f"{floor_ms:.3f} ms/step at 3.35 TB/s")

    eng = CompressionEngine(params, cfg, FrameFusionConfig())
    k_real, v_real, lens_real = eng.make_decode_state(prefill, steps + 4)
    log(f"  prefill per-layer cache lengths: {lens_real}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def random_pools(s_pool):
        shape = (cfg.num_layers, s_pool, cfg.num_kv_heads, cfg.head_dim_)
        return _rand(gen, shape, 0.1), _rand(gen, shape, 0.1)

    # The JAX bench's stand-in for the 64-frame geometry: two phase layers
    # with every prompt key, the rest at the compressed length.
    jax_lens = [11697] * 2 + [3292] * (cfg.num_layers - 2)
    geoms = [("uniform S=3328", *random_pools(3328), [3328 - steps - 4] * cfg.num_layers, 3328 - steps - 4),
             (f"prefill S_pool={int(k_real.shape[1])}", k_real, v_real, lens_real, prefill.decode_pos_base),
             ("JAX-bench S_pool=11776", *random_pools(11776), jax_lens, 11697)]
    impls = ("einsum", "flash", "ragged")
    out = {"floor_ms": floor_ms, "rows": []}
    for gname, kp, vp, lens, pos0 in geoms:
        split = best_tail_split(lens, int(kp.shape[1]), steps + 4, 128)
        for ts in ([None, split] if split is not None else [None]):
            # The step as a captured CUDA graph, "ragged" (kernel G, the
            # engine's decode) and "flash" (plain attention), in turns.
            graphs = {impl: decode_graph_on(params, cfg, kp, vp, lens, pos0, steps, impl, ts)
                      for impl in ("ragged", "flash")}
            readings = {impl: [] for impl in graphs}
            for impl in ("ragged", "flash", "flash", "ragged"):
                graph, first = graphs[impl]
                graph.start(lens, pos0, first)
                graph.run(1)  # warm
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                graph.run(steps - 1)
                stop.record()
                torch.cuda.synchronize()
                readings[impl].append(start.elapsed_time(stop) / (steps - 1))
            for impl, (graph, first) in graphs.items():
                ms = sum(readings[impl]) / len(readings[impl])
                graph.start(lens, pos0, first)
                launches = device_launches(lambda g=graph: g.run(1))
                captured = sum(graph.launches_per_step.values())
                out["rows"].append(dict(geometry=gname, impl=f"graph-{impl}", split=ts, ms_per_step=ms,
                                        readings=readings[impl], launches_per_step=launches,
                                        kernel_launches_captured=graph.launches_per_step))
                log(f"  decode_step[graph-{impl}] {gname:22s} split={str(ts):12s}: {ms:8.3f} ms/step "
                    f"({', '.join(f'{r:.3f}' for r in readings[impl])}; floor {floor_ms:.3f}), "
                    f"{launches} launches/step; {captured} calls of the kernels' wrappers captured a step "
                    f"({graph.launches_per_step})")
            del graphs
            # In turns (einsum, flash, ragged, ragged, flash, einsum): the
            # host-bound loop drifts between readings.
            readings = {impl: [] for impl in impls}
            for impl in impls + impls[::-1]:
                decode_loop(params, cfg, kp, vp, lens, pos0, 2, impl, ts)  # warm-up
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                decode_loop(params, cfg, kp, vp, lens, pos0, steps, impl, ts)
                stop.record()
                torch.cuda.synchronize()
                readings[impl].append(start.elapsed_time(stop) / steps)
            for impl in impls:
                ms = sum(readings[impl]) / len(readings[impl])
                launches = device_launches(lambda: decode_loop(params, cfg, kp, vp, lens, pos0, 1, impl, ts))
                out["rows"].append(dict(geometry=gname, impl=impl, split=ts, ms_per_step=ms,
                                        readings=readings[impl], launches_per_step=launches))
                log(f"  decode_step[{impl:6s}] {gname:22s} split={str(ts):12s}: {ms:8.3f} ms/step "
                    f"({', '.join(f'{r:.3f}' for r in readings[impl])}; floor {floor_ms:.3f}), "
                    f"{launches} launches/step")
    return out


# ---------------------------------------------------------------------------
# Counts for the bounds of the --what modes (plain functions of shapes)

ATTN_LENGTHS = (3328, 3456, 6656, 11776, 23552)
QUANT_SHAPE = (3328, 3584, 18944)
# Qwen2-7B's decode matvecs: (name, K, output widths); "gate-up" is kernel D.
DECODE_SHAPES = (("qkv", 3584, (3584, 512, 512)), ("wo", 3584, (3584,)), ("w_down", 18944, (3584,)),
                 ("gate-up", 3584, (18944, 18944)))
DECODE_LAYERS = 8
LEDGER_BUCKETS = (6528, 3328)  # the JAX ledger's pre-plan and plan buckets


def attn_flops(s: int, hq: int, d: int) -> float:
    """Causal attention's operations: QK^T and PV over the s(s+1)/2 pairs."""
    return 4 * hq * d * s * (s + 1) / 2


def attn_bytes(s: int, hq: int, hk: int, d: int) -> float:
    """Kernel A's bytes: q, k, v in (bf16), the output (bf16) and its row
    statistics m, l (fp32) out."""
    return (2 * s * hq * d + 2 * s * hk * d) * 2 + 2 * hq * s * 4


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2 * m * k * n


def gemm_bytes(m: int, k: int, n: int, in_bytes: int, out_bytes: int) -> float:
    """(m, k) . (k, n): both inputs read once, the output written once."""
    return (m * k + k * n) * in_bytes + m * n * out_bytes


def matvec_bytes(k: int, ns, w_bytes: int, rows: int = 1) -> float:
    """One kernel C/D call on ``rows`` bf16 rows: the (k, n) weights of each
    output width in ``ns`` (and their fp32 scales when int8), the rows in,
    the fp32 outputs out (kernel D writes one (rows, n) product for its two
    widths)."""
    gateup = len(ns) == 2
    out_cols = ns[0] if gateup else sum(ns)
    scales = sum(ns) * 4 if w_bytes == 1 else 0
    return k * sum(ns) * w_bytes + scales + rows * k * 2 + rows * out_cols * 4


def layer_params(cfg) -> tuple[int, int]:
    """One dense layer's GEMM weights: (attention projections q, k, v, o;
    the MLP's gate, up and down)."""
    d, hd = cfg.hidden_size, cfg.head_dim_
    return d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + cfg.num_heads * hd * d, 3 * d * cfg.intermediate_size


def prefill_ops(cfg, orig_len: int, events=(), start_layer: int = 0, stop_layer=None, logits_rows: int = 1) -> float:
    """The operations a prefill's layers [start_layer, stop_layer) need:
    GEMMs and causal attention over the rows each layer keeps live (each
    event's ``tokens_removed`` comes off the rows after its layer's
    attention, a layer -1 event before layer 0), plus the LM head over
    ``logits_rows`` rows. ``events``: (layer, tokens_removed) pairs; dead
    and pad rows cost nothing here."""
    stop_layer = cfg.num_layers if stop_layer is None else stop_layer
    p_attn, p_mlp = layer_params(cfg)
    removed = {}
    for layer, n in events:
        removed[layer] = removed.get(layer, 0) + n
    rows = orig_len - sum(n for layer, n in removed.items() if layer < start_layer)
    ops = 0.0
    for l in range(start_layer, stop_layer):
        ops += 2 * rows * p_attn + attn_flops(rows, cfg.num_heads, cfg.head_dim_)
        rows -= removed.get(l, 0)
        ops += 2 * rows * p_mlp
    return ops + 2 * logits_rows * cfg.hidden_size * cfg.vocab_size


def _row(log, name: str, ms: float, nbytes: float, ops: float, ops_per_s: float = H100_BF16_OPS_PER_S,
         **extra) -> dict:
    b, by = bound_ms(nbytes, ops, ops_per_s)
    row = dict(name=name, ms=ms, bound_ms=b, bound_by=by, **extra)
    rate = f"{ops / ms / 1e9:.1f} T(FL)OP/s" if by == "operations" else f"{nbytes / ms / 1e6:.0f} GB/s"
    more = "".join(f", {k} {v:.3e}" if k in ("err", "tol") else f", {k} {v:.4f}" if isinstance(v, float)
                   else f", {k} {v}" for k, v in extra.items())
    log(f"  {name:52s} {ms:9.4f} ms  bound {b:.4f} ({by}, {b / ms:.3f} of it)  {rate}{more}")
    return row


# ---------------------------------------------------------------------------
# --what attn


def row_failures(rows) -> list:
    """Names of the rows whose check (``err`` against ``tol``) failed."""
    return [r["name"] for r in rows if "tol" in r and not (math.isfinite(r["err"]) and r["err"] <= r["tol"])]


def bench_attention(log=print, reps: int = 5) -> list:
    """Kernel A (``flash_causal_attention``, the main path's causal call) at
    each length against causal SDPA, 28 / 4 heads of 128 in bf16; each
    output held against SDPA's (ATTN_ROW_RTOL of its row's largest)."""
    _require_cuda()
    from .ops.kernels import flash_prefill as fp

    gen = torch.Generator(device="cuda").manual_seed(0)
    hq, hk = 28, 4
    rows = []
    log(f"--- attn: kernel A vs causal SDPA, Hq {hq}, Hk {hk}, D {HD}, bf16")
    for s in ATTN_LENGTHS:
        q, k, v = _rand(gen, (s, hq, HD)), _rand(gen, (s, hk, HD)), _rand(gen, (s, hk, HD))
        err = row_rel_err(fp.flash_causal_attention(q, k, v), sdpa(q, k, v, is_causal=True)[0].transpose(0, 1))
        t_a = events_time_ms(lambda: fp.flash_causal_attention(q, k, v), reps)
        t_sdpa = events_time_ms(lambda: sdpa(q, k, v, is_causal=True), reps)
        rows.append(_row(log, f"A causal S {s}", t_a, attn_bytes(s, hq, hk, HD), attn_flops(s, hq, HD),
                         s=s, sdpa_ms=t_sdpa, err=err, tol=ATTN_ROW_RTOL))
        del q, k, v
    return rows


# ---------------------------------------------------------------------------
# --what quant


def bench_quant(log=print, reps: int = 10) -> list:
    """bf16 against int8 tensor-core GEMMs at the planned tail's MLP shape
    (library calls; the int8 bound is at the int8 peak)."""
    _require_cuda()
    from .models import qwen2

    m, k, n = QUANT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_bf, w_bf = _rand(gen, (m, k), 0.1), _rand(gen, (k, n), 0.1)
    x_i8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w_i8 = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen, device="cuda") + 0.5
    sw = torch.rand((n,), generator=gen, device="cuda") + 0.5
    w_cm = w_i8.t().contiguous().t()
    pair = {"q8": w_i8, "scale": sw}
    ops = gemm_flops(m, k, n)
    log(f"--- quant: ({m} x {k}) . ({k} x {n})")
    rows = [
        _row(log, "bf16 x bf16 -> bf16 (torch.matmul)", events_time_ms(lambda: torch.matmul(x_bf, w_bf), reps),
             gemm_bytes(m, k, n, 2, 2), ops),
        _row(log, "int8 x int8 -> int32 (torch._int_mm)", events_time_ms(lambda: qwen2._int8_matmul(x_i8, w_i8), reps),
             gemm_bytes(m, k, n, 1, 4), ops, H100_INT8_OPS_PER_S),
        # the same weights stored column-major (cuBLASLt's int8 kernels take the second operand so)
        _row(log, "int8 x int8 -> int32, weights column-major", events_time_ms(lambda: torch._int_mm(x_i8, w_cm), reps),
             gemm_bytes(m, k, n, 1, 4), ops, H100_INT8_OPS_PER_S),
        _row(log, "W8A8 epilogue: int32 -> fp32 descale -> bf16",
             events_time_ms(lambda: (qwen2._int8_matmul(x_i8, w_i8).float() * sx * sw).to(torch.bfloat16), reps),
             gemm_bytes(m, k, n, 1, 2) + m * 4 + n * 4, ops, H100_INT8_OPS_PER_S),
        _row(log, "W8A8 qwen2.mm (activations quantized per row)",
             events_time_ms(lambda: qwen2.mm(x_bf, pair, w8a8=True), reps),
             m * k * 2 + k * n + n * 4 + m * n * 2, ops, H100_INT8_OPS_PER_S),
        _row(log, "weight-only int8 qwen2.mm (the prefill's today)", events_time_ms(lambda: qwen2.mm(x_bf, pair), reps),
             m * k * 2 + k * n + n * 4 + m * n * 2, ops),
    ]
    log(f"  int8 / bf16 GEMM time: {rows[1]['ms'] / rows[0]['ms']:.3f} (weights column-major "
        f"{rows[2]['ms'] / rows[0]['ms']:.3f}); W8A8 mm / bf16: {rows[4]['ms'] / rows[0]['ms']:.3f}")
    return rows


# ---------------------------------------------------------------------------
# --what decode


def bench_decode(log=print, iters: int = 4) -> list:
    """Kernels C and D at Qwen2-7B's decode shapes, int8 and bf16, timed
    from CUDA-graph replays of one call a layer of a ``DECODE_LAYERS``-deep stack
    (no layer is read twice in a row), with effective GB/s; the stacked MLP
    chain; ``torch.sum`` over the same int8 stacks as a read-rate yardstick.
    Each stack's last layer is first held against the plain version
    (GEMV_RTOL of the largest output)."""
    _require_cuda()
    from .ops.kernels import matvec_q8 as mv

    n_l = DECODE_LAYERS
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = _rand(gen, (1, 3584), 0.1)
    rows = []

    def stack(kdim, n, wdtype):
        if wdtype == "int8":
            return torch.randint(-127, 128, (n_l, kdim, n), generator=gen, device="cuda", dtype=torch.int8)
        return _rand(gen, (n_l, kdim, n), 0.01)

    def scales(n, wdtype):
        return (torch.rand((n_l, n), generator=gen, device="cuda") * 0.01 + 0.005) if wdtype == "int8" else None

    log(f"--- decode: kernels C and D, one row, {n_l}-layer stacks, graph replays")
    for wdtype in ("int8", "bf16"):
        wb = 1 if wdtype == "int8" else 2
        for name, kdim, ns in DECODE_SHAPES:
            xk = x if kdim == 3584 else _rand(gen, (1, kdim), 0.1)
            ws = [stack(kdim, n, wdtype) for n in ns]
            if name == "gate-up":
                sg, su = scales(ns[0], wdtype), scales(ns[1], wdtype)
                fn = lambda ws=ws, sg=sg, su=su: [mv.gemv_gateup(xk, ws[0], ws[1], sg, su, l) for l in range(n_l)]
                err = rel_err(mv.gemv_gateup(xk, ws[0], ws[1], sg, su, n_l - 1),
                              mv.gemv_gateup_plain(xk, ws[0], ws[1], sg, su, n_l - 1))
                kernel = "D"
            else:
                fn = lambda ws=ws, xk=xk: [mv.gemv_stacked(xk, ws, l) for l in range(n_l)]
                err = max(rel_err(a, b) for a, b in zip(mv.gemv_stacked(xk, ws, n_l - 1),
                                                          mv.gemv_stacked_plain(xk, ws, n_l - 1)))
                kernel = "C"
            ms = graph_time_ms(fn, iters) / n_l
            rows.append(_row(log, f"{kernel} {name} {wdtype} {kdim} -> {'+'.join(map(str, ns))}", ms,
                             matvec_bytes(kdim, ns, wb), 2 * kdim * sum(ns), err=err, tol=GEMV_RTOL))
            del ws
        # The decode graph's MLP chain: D (gate-up) then C (down), layer after layer.
        wg, wu, wd = stack(3584, 18944, wdtype), stack(3584, 18944, wdtype), stack(18944, 3584, wdtype)
        sg, su = scales(18944, wdtype), scales(18944, wdtype)

        def chain():
            h = x
            for l in range(n_l):
                u = mv.gemv_gateup(h, wg, wu, sg, su, l).to(torch.bfloat16)
                h = h + (mv.gemv_stacked(u, [wd], l)[0] * 1e-30).to(torch.bfloat16)
            return h

        u = mv.gemv_gateup_plain(x, wg, wu, sg, su, n_l - 1)
        err = max(rel_err(mv.gemv_gateup(x, wg, wu, sg, su, n_l - 1), u),
                  rel_err(mv.gemv_stacked(u.to(torch.bfloat16), [wd], n_l - 1)[0],
                          mv.gemv_stacked_plain(u.to(torch.bfloat16), [wd], n_l - 1)[0]))
        nbytes = n_l * (matvec_bytes(3584, (18944, 18944), wb) + matvec_bytes(18944, (3584,), wb))
        rows.append(_row(log, f"MLP chain {wdtype} ({n_l} layers, D then C)", graph_time_ms(chain, 2), nbytes,
                         n_l * 6 * 3584 * 18944, err=err, tol=GEMV_RTOL))
        if wdtype == "int8":
            rows.append(_row(log, "torch.sum over the same int8 stacks (read rate)",
                             events_time_ms(lambda: (wg.sum(dtype=torch.int32), wu.sum(dtype=torch.int32),
                                                     wd.sum(dtype=torch.int32)), 3),
                             3 * n_l * 3584 * 18944, 0))
        del wg, wu, wd
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# --what engine and --what ledger


def engine_model(vocab_size: int = 8192, seed: int = 0):
    """Random Qwen2-7B weights (bf16, on the card) at a cut vocabulary, as
    the JAX bench's engine and ledger modes draw theirs."""
    _require_cuda()
    from .config import qwen2_7b_config
    from .models import qwen2

    cfg = qwen2_7b_config(vocab_size=vocab_size)
    return qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed)), cfg


def _main_prompt(cfg):
    """The 64-frame x 182-patch prompt (11,697 tokens) on the card."""
    from .models.adapters.common import build_video_prompt

    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size, n_frames=64)
    return torch.from_numpy(h).to("cuda", cfg.dtype), pt, np.arange(len(pt)), img_start, n_img


def _events(res) -> list:
    return [(e.layer, e.tokens_removed) for e in res.telemetry.events]


def logits_err(logits, events, valid_len: int, ref) -> float:
    """``logits``' error over the largest of the reference prefill ``ref``'s,
    or inf when the events or the final length differ from ``ref``'s."""
    if events != _events(ref) or valid_len != ref.valid_len:
        return math.inf
    return rel_err(logits, ref.logits)


def planned_stages(engine, prompt, pre_plan: int, plan: int, log=print, reps: int = 3) -> list:
    """The planned prefill's stages, each timed alone (CUDA events, the
    state it needs rebuilt untimed around it): the layer-0 merge and its
    compaction to ``pre_plan``, the mask-only phase, the compaction to
    ``plan``, the tail (with the phase's deferred MLP), and the pack of the
    phase layers' caches; each beside its floor (GEMM and attention
    operations over the live rows; bytes for the compactions and the pack).
    The tail's logits are held against a whole ``prefill_planned`` at the
    same buckets (ENGINE_RTOL, the same events)."""
    import copy

    from .core.compact import bucket_length, compact_tokens
    from .runtime.engine import _PhaseState

    cfg, ff = engine.cfg, engine.ff
    h, pt, pos, img_start, n_img = prompt
    hp, ptp, posp, orig = engine._prep_inputs(h, pt, pos)
    frame_tok = engine._frame_tokens(pt)
    d, kv_row = cfg.hidden_size, cfg.num_kv_heads * cfg.head_dim_ * 2
    p_mlp = layer_params(cfg)[1]

    def pre():
        st = _PhaseState(n_live=orig, frame_tok=frame_tok)
        return engine._pre_event(hp, ptp, posp, orig, st, 182, new_len=pre_plan), st

    (h1, pt1, pos1, _), st1 = pre()
    live1 = torch.arange(pre_plan, device=h1.device) < st1.n_live

    def phase():
        st = copy.deepcopy(st1)
        return engine._phase(h1, pt1, pos1, live1, st, orig_len=orig, image_start=img_start, image_len=n_img,
                             patch_num=182, stop_layer=engine.pool_layers, include_pre_event=False,
                             defer_final_mlp=True), st

    (h2, live2, layer_end, caches, pending), st2 = phase()
    plan = max(plan, bucket_length(st2.n_live, ff.bucket))

    def compact():
        return compact_tokens(live2, plan, st2.n_live, {"h": h2, "pos": pos1})[0]

    out = compact()

    def tail():
        return engine._tail(out["h"], out["pos"], st2.n_live, layer_end, pending)

    events = [(e.layer, e.tokens_removed) for e in st2.events]
    err = logits_err(tail()[0], events, st2.n_live,
                     engine.prefill_planned(h, pt, pos, 182, img_start, n_img, plan_len=plan, pre_plan_len=pre_plan))
    deferred = 2 * st2.n_live * p_mlp if pending >= 0 else 0  # the phase's last MLP runs in the tail
    log(f"  stages at pre-plan {pre_plan}, plan {plan}: {st1.n_live} rows after the layer-0 merge, "
        f"{st2.n_live} after the phase ({layer_end} layers, MLP of layer {pending} deferred), events {events}")
    rows = [
        _row(log, f"pre-event merge + compaction ({orig} -> {pre_plan})",
             events_time_ms(pre, reps, warmup=1), (orig + pre_plan) * d * 2, 0),
        _row(log, f"phase ({layer_end} layers at {pre_plan})", events_time_ms(phase, reps, warmup=1), 0,
             prefill_ops(cfg, st1.n_live, [(l, n) for l, n in events if l >= 0], stop_layer=layer_end,
                         logits_rows=0) - deferred),
        _row(log, f"compaction ({pre_plan} -> {plan})", events_time_ms(compact, reps, warmup=1),
             (pre_plan + plan) * d * 2, 0),
        _row(log, f"tail ({cfg.num_layers - layer_end} layers at {plan})", events_time_ms(tail, reps, warmup=1), 0,
             prefill_ops(cfg, st2.n_live, start_layer=layer_end) + deferred, err=err, tol=ENGINE_RTOL),
        _row(log, f"pack of the phase caches ({len(caches)} layers)",
             events_time_ms(lambda: engine._pack_caches(caches), reps, warmup=1),
             sum(2 * (pre_plan + int(c[2].sum())) * kv_row for c in caches), 0),
    ]
    log(f"  sum of the stages: {sum(r['ms'] for r in rows):.3f} ms (floors {sum(r['bound_ms'] for r in rows):.3f})")
    return rows


def bench_engine(params=None, cfg=None, log=print, reps: int = 2) -> list:
    """The FrameFusion prefills of the main path's prompt at Qwen2-7B width
    beside dense, each beside the floor of the rows its events kept and held
    against the fused prefill (the same events, logits within ENGINE_RTOL);
    the planned prefill's stage split; the pieces alone; decode tokens/s."""
    from .config import FrameFusionConfig
    from .core.compact import bucket_length
    from .models import qwen2
    from .runtime.engine import CompressionEngine, PlanHistory

    if params is None:
        params, cfg = engine_model(8192)
    _require_cuda()
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    e = CompressionEngine(params, cfg, ff)
    prompt = _main_prompt(cfg)
    h, pt, pos, img_start, n_img = prompt
    s = len(pt)
    args = (h, pt, pos, 182, img_start, n_img)
    rows = []
    log(f"--- engine: the {s}-token prompt at Qwen2-7B width, vocab {cfg.vocab_size}, cost 0.3, S_th 0.6, r_min 0.1")
    res = e.prefill(*args)
    log(f"  fused events {[(ev.layer, ev.kind, ev.tokens_removed) for ev in res.telemetry.events]}, "
        f"final {res.valid_len}, tail from layer {res.telemetry.tail_start_layer}")
    floor_ops = prefill_ops(cfg, s, _events(res))
    variants = [("fused prefill", lambda: e.prefill(*args)),
                ("planned (1-stage, plan 3456)", lambda: e.prefill_planned(*args, plan_len=3456))]
    variants += [(f"planned (2-stage, pre {pre}, plan 3456)",
                  lambda pre=pre: e.prefill_planned(*args, plan_len=3456, pre_plan_len=pre))
                 for pre in (8832, 7680, 6656)]
    variants += [("planned (PlanHistory's buckets)", lambda: e.prefill(*args, mode="planned")),
                 ("segmented prefill", lambda: e.prefill(*args, mode="segmented"))]
    for name, fn in variants:
        out = fn()
        err = logits_err(out.logits, _events(out), out.valid_len, res)
        rows.append(_row(log, name, events_time_ms(fn, reps, warmup=1), 0, floor_ops, mode=out.mode, err=err,
                         tol=ENGINE_RTOL))
        del out
    dense_ops = prefill_ops(cfg, s)
    pos_t = torch.from_numpy(pos).to("cuda")
    for want in (False, True):
        fn = lambda want=want: qwen2.dense_prefill(params, h, pos_t, cfg, attn_impl="flash", want_caches=want)
        rows.append(_row(log, f"dense prefill ({'with caches' if want else 'logits only'})",
                         events_time_ms(fn, reps, warmup=1), 0, dense_ops))
    pre_plan, plan = e.plan_history.suggest(PlanHistory.key(182, 64, ff), ff.bucket)
    log("  the planned prefill split at PlanHistory's buckets:")
    rows += planned_stages(e, prompt, pre_plan, plan, log, reps)

    s_small, start, valid = 3328, 2, 3314
    h2 = _rand(torch.Generator(device="cuda").manual_seed(1), (s_small, cfg.hidden_size), 0.1)
    pos2 = torch.arange(s_small, device="cuda")[:, None]
    rows.append(_row(log, f"tail alone: layers {start}-{cfg.num_layers - 1} at S {s_small}",
                     events_time_ms(lambda: e._tail(h2, pos2, valid, start), reps, warmup=1), 0,
                     prefill_ops(cfg, valid, start_layer=start)))
    s_pool = bucket_length(s, ff.bucket)
    kv = _rand(torch.Generator(device="cuda").manual_seed(2), (s_pool, cfg.num_kv_heads, HD), 0.1)
    live = torch.ones((s_pool,), dtype=torch.bool, device="cuda")
    caches = [(kv, kv, live)] * 8
    rows.append(_row(log, f"pack caches (8 layers at S {s_pool})",
                     events_time_ms(lambda: e._pack_caches(caches), reps, warmup=1),
                     8 * 2 * 2 * s_pool * cfg.num_kv_heads * HD * 2, 0))

    n_tok = 32
    t = events_time_ms(lambda: e.generate(res, n_tok), reps, warmup=1)
    log(f"  decode {n_tok} tokens, one graph: {t:.2f} ms ({n_tok / t * 1e3:.1f} tokens/s)")
    rows.append(dict(name=f"decode {n_tok} tokens solo", ms=t, tokens_per_s=n_tok / t * 1e3))
    for b in (1, 4):
        t = events_time_ms(lambda b=b: e.generate_batch([res] * b, n_tok), reps, warmup=1)
        log(f"  decode {n_tok} tokens batched B={b}: {t:.2f} ms ({b * n_tok / t * 1e3:.1f} tokens/s)")
        rows.append(dict(name=f"decode {n_tok} tokens B={b}", ms=t, tokens_per_s=b * n_tok / t * 1e3))
    return rows


def bench_ledger(params=None, cfg=None, log=print, reps: int = 3) -> list:
    """The planned prefill's stages alone at the JAX ledger's buckets, each
    beside its floor."""
    from .config import FrameFusionConfig
    from .runtime.engine import CompressionEngine

    if params is None:
        params, cfg = engine_model(8192)
    _require_cuda()
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    e = CompressionEngine(params, cfg, ff)
    log(f"--- ledger: the planned prefill's stages, Qwen2-7B width, vocab {cfg.vocab_size}")
    return planned_stages(e, _main_prompt(cfg), *LEDGER_BUCKETS, log=log, reps=reps)


BENCH_MODES = ("attn", "quant", "decode", "engine", "ledger")


def run_modes(modes, log=print) -> dict:
    """Run the given ``--what`` modes in order (engine and ledger share one
    model); returns their rows by mode."""
    out, model = {}, None
    for mode in modes:
        if mode == "attn":
            out[mode] = bench_attention(log)
        elif mode == "quant":
            out[mode] = bench_quant(log)
        elif mode == "decode":
            out[mode] = bench_decode(log)
        elif mode in ("engine", "ledger"):
            model = model or engine_model(8192)
            out[mode] = (bench_engine if mode == "engine" else bench_ledger)(*model, log=log)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="kernel check on the card")
    ap.add_argument("--batch-parity", action="store_true", help="batched-vs-solo prefill decisions on the card")
    ap.add_argument("--what", choices=BENCH_MODES + ("decodestep", "all"), help="benchmark to run")
    args = ap.parse_args(argv)
    if not args.check and not args.batch_parity and args.what is None:
        ap.error("give --check, --batch-parity or --what MODE")
    _require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    failures = 0
    if args.check:
        t0 = time.perf_counter()
        failures = check_kernels()
        print(f"check: {time.perf_counter() - t0:.1f} s")
    if args.batch_parity:
        failures += check_batch_parity()
    if args.what == "decodestep":
        bench_decodestep()
    elif args.what is not None:
        out = run_modes(BENCH_MODES if args.what == "all" else (args.what,))
        failed = [name for rows in out.values() for name in row_failures(rows)]
        print(f"checked rows failed: {failed}" if failed else "every checked row within its bound")
        failures += len(failed)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
