"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printed as it runs; every run makes all of them:

1. device  — the card's name and power limit (nvidia-smi), then the kernels'
             build from ``framefusion_tpu_torch/csrc`` and its time.
2. kernels — each hand-written kernel against its plain PyTorch version on
             the card, at the main path's shapes (and, for kernel F, at small
             odd shapes covering its edge cases), with the stated bound, and
             both timed with CUDA events.
3. cross   — a tiny bf16 model, its weights drawn with numpy from a seed,
             through the compressed prefill and greedy decode twice: plain
             versions on the CPU, kernels on the card. Events, cache lengths
             and tokens must be equal, the tokens must vary, and the prefill
             logits must agree within a stated bf16 bound.
4. full    — random Qwen2-7B weights (bf16 on the card) and the 64-frame
             LLaVA-Video prompt: apply_framefusion + generate (fused), the
             planned prefill + generate, and the dense prefill. Kernel launch
             counts are read around the fused run.
5. cross_vision — a tiny SigLIP tower (head dim 72) and projector with the
             tiny LLM of phase 3, weights drawn with numpy, through
             TextPipeline.ask on uint8 frames: plain versions on the CPU,
             kernels on the card. The frontend features agree within a
             stated bf16 bound; events, cache lengths and tokens are equal
             and the tokens vary.
6. pixels  — pixels to answer at full width: random SigLIP-so400m tower,
             projector and Qwen2-7B (bf16), 64 uint8 frames at 360x480
             through the native preprocessing, the tower (kernel E), the
             LLaVA frontend, the compressed prefill and 8 greedy tokens;
             FrameFusion and dense, encode and pixels-to-answer times, kernel
             launch counts read around the FrameFusion run, then the W8A8
             tower once.
7. cross_baselines — the tiny model of phase 3 through every baseline
             method (FastV, StreamingLLM with kernel F, fixed-schedule merging,
             merge->FastV, FastV->merge, the sink-cache decode) via
             replace_forward + generate: plain versions on the CPU, kernels on
             the card. Events, cache lengths and tokens are equal; the
             prefill logits, and the sink-cache decode's last-step logits,
             agree within the bf16 bound. The weights give every token one
             clear successor, so the tokens hold by construction (they do not
             depend on the method either): the logits bounds are what can fail.
8. baselines — the paper's method comparison at full width: random Qwen2-7B
             weights (bf16) and the 64-frame prompt through dense,
             FrameFusion and the six baseline settings of
             scripts/example_baselines.py: prefill times, tokens kept, 8 greedy
             tokens each; kernel launch counts read around the whole
             comparison, kernel F's around each StreamingLLM prefill; then F
             against its plain version on that prefill's layer-0 q, k, v.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. The script never runs on the CPU: without a CUDA device
it exits at once.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, with their reasons:
# * Kernel A writes bf16 outputs and feeds bf16-rounded probabilities to the
#   P.V product (the plain version keeps fp32 throughout): a bf16 ulp is
#   2^-8 to 2^-7 relative, so each (row, head) output agrees to ATTN_ROW_RTOL
#   (a few ulps) relative to that row's own largest output. The bound is per
#   row because late rows average thousands of keys and are 100x smaller
#   than the first rows: a bound on the whole tensor would let a P.V error in
#   the late tiles pass. The fp32 row statistics, untouched by bf16
#   rounding, agree to STAT_RTOL.
ATTN_ROW_RTOL = 2e-2
STAT_RTOL = 1e-3
# * Kernel B sums the same fp32 terms as its plain version in another order:
#   fp32 rounding only, relative to the largest importance.
IMP_RTOL = 1e-4
# * Kernels C/D accumulate bf16 x bf16/int8 products in fp32 in another order
#   than cuBLAS: fp32 rounding over K <= 18944 terms, relative to the
#   output's largest magnitude.
GEMV_RTOL = 1e-4
# * Kernel E (bidirectional attention) rounds its probabilities and outputs
#   to bf16 like kernel A, and is held per (row, head) to ATTN_ROW_RTOL too;
#   so is kernel F (StreamingLLM sink + window attention), which computes
#   like A over fewer keys.
# * The cross-device vision run: the tiny tower's bf16 frontend features
#   differ from its fp32 run by 6.7e-3 of the largest feature on the CPU
#   (same numpy weights and frames); the card's bf16 run rounds elsewhere
#   (kernel E's bf16 probabilities, other summation orders), so it may
#   differ from the CPU's by up to about twice that.
FEATURE_RTOL = 1.5e-2
# * The cross-device run: the tiny model's bf16 prefill logits differ from
#   its fp32 run by 2.85e-2 of the largest logit on the CPU (same numpy
#   weights and prompt); two bf16 runs with other roundings (kernel A's bf16
#   probabilities, other summation orders) may differ by up to about twice
#   that.
LOGIT_RTOL = 6e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Checks:
    def __init__(self):
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)


def phase_device(chk: Checks) -> None:
    from framefusion_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    lib_path, seconds = _build.build()
    log(f"kernel build: {seconds:.1f} s -> {lib_path.name}")
    for name, usage in ptxas_usage(lib_path.with_suffix(".log").read_text()):
        log(f"  ptxas: {name}: {usage}")
    _build.load_library()


def _kernel_name(mangled: str) -> str:
    """Short name of a mangled ``namespace::kernel<arg>``: the last name of
    the nested-name, with its template argument (an int, or the uint16_t /
    int8_t element type of the bf16 / int8 instantiations)."""
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    arg = re.match(r"I(?:Li(\d+)|([ta]))E", mangled[i:])
    if arg is None:
        return name
    return f"{name}<{arg.group(1) or {'t': 'bf16', 'a': 'int8'}[arg.group(2)]}>"


def ptxas_usage(log_text: str) -> list:
    """(kernel, "registers, shared memory, spills") per kernel of nvcc's
    ``-Xptxas -v`` output."""
    out, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name is not None:
            usage = line.split(":", 1)[1].strip() if ":" in line else line.strip()
            out.append((name, f"{usage}; {spills}"))
            name = None
    return out


def _max_err(entry: dict, err: float) -> None:
    entry["max_abs_err"] = err if entry["max_abs_err"] is None else max(entry["max_abs_err"], err)


def _rand(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def phase_kernels(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch.core import descending_rank
    from framefusion_tpu_torch.ops.attention import capture_rows
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp
    from framefusion_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(1234)
    hq, hk, d = 28, 4, 128

    # -- kernel A (and the statistics kernel B reads) --------------------
    cases = {}
    for s, dead in ((11776, 0.0), (6528, 0.45)):
        q, k, v = _rand(gen, (s, hq, d)), _rand(gen, (s, hk, d)), _rand(gen, (s, hk, d))
        kv = None
        if dead:
            kv = torch.rand((s,), generator=gen, device="cuda") >= dead
            kv[:16] = False  # rows 0..15 see no valid key at all
            kv[-1] = True
        out, m, l = fp.flash_attn_fwd(q, k, v, kv)
        out_p, m_p, l_p = fp.flash_attn_fwd_plain(q, k, v, kv)
        torch.cuda.synchronize()
        err_rh = (out.float() - out_p.float()).abs().amax(-1)  # (S, Hq)
        row_rel = err_rh / out_p.float().abs().amax(-1).clamp(min=1e-30)  # 0/0 rows (all masked) give 0
        err = err_rh.max().item()
        rel, rel_late = row_rel.max().item(), row_rel[1024:].max().item()
        fin = torch.isfinite(m_p)
        m_err = (m - m_p)[fin].abs().max().item()
        l_rel = ((l - l_p).abs() / l_p.clamp(min=1e-30))[fin].max().item()
        tag = f"A S={s} dead={dead:.2f}"
        chk.expect(rel <= ATTN_ROW_RTOL,
                   f"{tag}: max_abs_err {err:.3e}; per (row, head) error / its largest output: max {rel:.3e}, "
                   f"rows >= 1024 {rel_late:.3e}; <= {ATTN_ROW_RTOL}")
        chk.expect(m_err <= STAT_RTOL and l_rel <= STAT_RTOL,
                   f"{tag}: row max err {m_err:.3e}, row sum rel err {l_rel:.3e} <= {STAT_RTOL}")
        if dead:
            chk.expect(bool((out[:16] == 0).all()) and bool((l[:, :16] == 0).all()),
                       f"{tag}: rows with every key masked give 0")
        t_k = cuda_time_ms(lambda: fp.flash_attn_fwd(q, k, v, kv), iters=10)
        t_p = cuda_time_ms(lambda: fp.flash_attn_fwd_plain(q, k, v, kv), iters=2, warmup=1)
        log(f"  {tag}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
        cases[s] = (q, k, kv, m, l)
        _max_err(kernels["flash_attn_fwd"], err)
        if s == 6528:
            kernels["flash_attn_fwd"].update(ms=t_k, plain_ms=t_p)

    # -- kernel B -------------------------------------------------------
    q, k, kv, m, l = cases[6528]
    s = q.shape[0]
    live_rows = torch.nonzero(kv).flatten()
    row_sets = {
        "num=1": capture_rows(s, 1, None, kv),
        "num=4": capture_rows(s, 4, None, kv),
        "num=4 sentinel": torch.cat([torch.full((2,), -1, device="cuda"), live_rows[-2:]]),
    }
    for tag, rows in row_sets.items():
        imp = fp.attn_importance_rows(q, k, rows, m, l, kv)
        imp_p = fp.attn_importance_rows_plain(q, k, rows, m, l, kv)
        torch.cuda.synchronize()
        err = (imp - imp_p).abs().max().item()
        rel = err / imp_p.abs().max().item()
        chk.expect(rel <= IMP_RTOL, f"B {tag} S={s}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {IMP_RTOL}")
        n_keep = int(0.3 * int(kv.sum()))
        ninf = torch.full_like(imp, float("-inf"))
        keep = descending_rank(torch.where(kv, imp, ninf)) < n_keep
        keep_p = descending_rank(torch.where(kv, imp_p, ninf)) < n_keep
        chk.expect(bool((keep == keep_p).all()), f"B {tag}: top-{n_keep} keep set equals the plain one")
        _max_err(kernels["attn_importance_rows"], err)
        if tag == "num=1":
            t_k = cuda_time_ms(lambda: fp.attn_importance_rows(q, k, rows, m, l, kv), iters=20)
            t_p = cuda_time_ms(lambda: fp.attn_importance_rows_plain(q, k, rows, m, l, kv), iters=5)
            log(f"  B {tag} S={s}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
            kernels["attn_importance_rows"].update(ms=t_k, plain_ms=t_p)
    del cases, q, k, m, l

    # -- kernels C and D at the decode shapes --------------------------------
    hid, inter = 3584, 18944
    shapes = {"qkv": (hid, [hid, 512, 512]), "wo": (hid, [hid]), "w_down": (inter, [hid]),
              "gateup": (hid, [inter, inter])}
    for wdtype in ("bf16", "int8"):
        for name, (kdim, ns) in shapes.items():
            per_layer = kdim * sum(ns) * (1 if wdtype == "int8" else 2)
            n_layers = max(2, math.ceil(150e6 / per_layer))  # cycle layers past the 50 MB L2
            x = _rand(gen, (1, kdim))
            stacks, scales = [], []
            for n in ns:
                w = _rand(gen, (n_layers, kdim, n), scale=0.02)
                if wdtype == "int8":
                    wq = quantize_weight(w)
                    stacks.append(wq["q8"])
                    scales.append(wq["scale"])
                else:
                    stacks.append(w)
                    scales.append(None)
                del w
            layer = [0]

            def next_layer():
                layer[0] = (layer[0] + 1) % n_layers
                return layer[0]

            if name == "gateup":
                out = mv.gemv_gateup(x, stacks[0], stacks[1], scales[0], scales[1], 1)
                ref = mv.gemv_gateup_plain(x, stacks[0], stacks[1], scales[0], scales[1], 1)
                outs, refs = [out], [ref]
                run_k = lambda: mv.gemv_gateup(x, stacks[0], stacks[1], scales[0], scales[1], next_layer())
                run_p = lambda: mv.gemv_gateup_plain(x, stacks[0], stacks[1], scales[0], scales[1], next_layer())
                key = "gemv_gateup"
            else:
                outs = mv.gemv_stacked(x, stacks, 1)
                refs = mv.gemv_stacked_plain(x, stacks, 1)
                run_k = lambda: mv.gemv_stacked(x, stacks, next_layer())
                run_p = lambda: mv.gemv_stacked_plain(x, stacks, next_layer())
                key = "gemv_stacked"
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
            rel = err / max(r.abs().max().item() for r in refs)
            chk.expect(rel <= GEMV_RTOL, f"{key} {name} {wdtype} K={kdim} N={ns}: max_abs_err {err:.3e} (rel {rel:.3e}) <= {GEMV_RTOL}")
            t_k = cuda_time_ms(run_k, iters=20)
            t_p = cuda_time_ms(run_p, iters=20)
            gbs = per_layer / (t_k * 1e-3) / 1e9
            log(f"  {key} {name} {wdtype}: kernel {t_k:.4f} ms ({gbs:.0f} GB/s of weights), plain {t_p:.4f} ms")
            _max_err(kernels[key], err)
            if wdtype == "bf16" and name in ("qkv", "gateup"):
                kernels[key].update(ms=t_k, plain_ms=t_p)
            del stacks, scales

    # -- kernel E at the tower's shapes (so400m: 16 frames, N 729, 16 heads,
    # head dim 72), and head dims 64 / 80 of the later towers ---------------
    for b, n, h, hd in ((16, 729, 16, 72), (4, 1025, 16, 64), (4, 1296, 16, 80)):
        q, k, v = (_rand(gen, (b, n, h, hd)) for _ in range(3))
        out = ba.flash_bidir_attention(q, k, v)
        ref = ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5)
        torch.cuda.synchronize()
        err_rh = (out.float() - ref.float()).abs().amax(-1)  # (B, N, H)
        rel = (err_rh / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()
        err = err_rh.max().item()
        tag = f"E B={b} N={n} H={h} hd={hd}"
        chk.expect(rel <= ATTN_ROW_RTOL, f"{tag}: max_abs_err {err:.3e}; per (row, head) error / its largest "
                                         f"output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
        _max_err(kernels["bidir_attn_fwd"], err)
        t_k = cuda_time_ms(lambda: ba.flash_bidir_attention(q, k, v), iters=20)
        t_p = cuda_time_ms(lambda: ba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5), iters=3, warmup=1)
        tflops = 4 * b * h * n * n * hd / (t_k * 1e-3) / 1e12
        log(f"  {tag}: kernel {t_k:.4f} ms ({tflops:.1f} TFLOP/s), plain {t_p:.4f} ms")
        if hd == 72:
            kernels["bidir_attn_fwd"].update(ms=t_k, plain_ms=t_p)
        del q, k, v, out, ref

    # -- kernel F at the StreamingLLM prefill's full-width shapes (S 11,697,
    # init 8, window int(0.3 S) - 8; S 11,776, the bucket-padded length the
    # prefill launches F at) and at small odd shapes ------------------------
    for s, hq_, hk_, init_num, window in (
            (11697, hq, hk, 8, int(0.3 * 11697) - 8),
            (11776, hq, hk, 8, int(0.3 * 11697) - 8),
            (200, 4, 4, 8, 24),  # G = 1
            (333, hq, hk, 8, 1),  # the diagonal and the sinks only
            (301, 14, 2, 0, 50),  # no sink keys
            (517, hq, hk, 100, 30),  # init_num > window: sink and window tiles overlap
            (190, hq, hk, 8, 4096)):  # window >= S: causal attention, as kernel A
        q, k, v = _rand(gen, (s, hq_, d)), _rand(gen, (s, hk_, d)), _rand(gen, (s, hk_, d))
        out = sp.sink_attn_fwd(q, k, v, init_num, window)
        refs = {"plain": sp.sink_attn_fwd_plain(q, k, v, init_num, window)}
        if window >= s:
            refs["kernel A"] = fp.flash_attn_fwd(q, k, v)[0]
        torch.cuda.synchronize()
        tag = f"F S={s} Hq={hq_} Hk={hk_} init={init_num} window={window}"
        for name, ref in refs.items():
            err_rh = (out.float() - ref.float()).abs().amax(-1)  # (S, Hq)
            rel = (err_rh / ref.float().abs().amax(-1).clamp(min=1e-30)).max().item()
            chk.expect(rel <= ATTN_ROW_RTOL, f"{tag} vs {name}: max_abs_err {err_rh.max().item():.3e}; per (row, "
                                             f"head) error / its largest output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
        _max_err(kernels["sink_attn_fwd"], (out.float() - refs["plain"].float()).abs().max().item())
        if s == 11697:
            t_k = cuda_time_ms(lambda: sp.sink_attn_fwd(q, k, v, init_num, window), iters=10)
            t_p = cuda_time_ms(lambda: sp.sink_attn_fwd_plain(q, k, v, init_num, window), iters=2, warmup=1)
            t_a = cuda_time_ms(lambda: fp.flash_attn_fwd(q, k, v), iters=10)
            rows = np.arange(s)
            keys = np.minimum(rows + 1, window) + np.minimum(init_num, np.maximum(rows - window + 1, 0))
            tflops = 4 * hq_ * d * float(keys.sum()) / (t_k * 1e-3) / 1e12
            log(f"  {tag}: kernel {t_k:.3f} ms ({tflops:.1f} TFLOP/s), plain {t_p:.3f} ms; kernel A (causal) at "
                f"this S {t_a:.3f} ms, F / A {t_k / t_a:.3f}")
            kernels["sink_attn_fwd"].update(ms=t_k, plain_ms=t_p)
        del q, k, v, out, refs


def phase_cross(chk: Checks) -> None:
    from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4,
                          num_kv_heads=2, dtype=torch.bfloat16)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1,
                           schedule_num_layers=6, bucket=32)
    tree = numpy_params(cfg, seed=0, scale=0.05)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5)
    pos = np.arange(len(pt))
    results = {}
    for dev in ("cpu", "cuda"):
        params = _cast_floats(qwen2.params_from_numpy(tree, dev), cfg.dtype)
        eng = CompressionEngine(params, cfg, ff, attn_impl="flash")
        for mode in ("fused", "planned"):
            res = eng.prefill(h, pt, pos, 8, img_start, n_img, mode=mode)
            toks = eng.generate(res, 8)
            results[(dev, mode)] = ([(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
                                    [c[2] for c in res.layer_caches], toks, res.mode, res.logits.float().cpu())
    for mode in ("fused", "planned"):
        cpu, gpu = results[("cpu", mode)], results[("cuda", mode)]
        rel = float((cpu[4] - gpu[4]).abs().max() / cpu[4].abs().max())
        log(f"  {mode}: cpu events {cpu[0]} tokens {cpu[2]}; cuda events {gpu[0]} tokens {gpu[2]} ({gpu[3]})")
        chk.expect(cpu[0] == gpu[0] and cpu[1] == gpu[1], f"cross {mode}: events and cache lengths equal")
        chk.expect(cpu[2] == gpu[2], f"cross {mode}: greedy tokens equal")
        chk.expect(len(set(gpu[2])) >= 3, f"cross {mode}: the tokens vary ({len(set(gpu[2]))} distinct of 8)")
        chk.expect(rel <= LOGIT_RTOL, f"cross {mode}: prefill logits differ by {rel:.3e} of their largest "
                                      f"<= {LOGIT_RTOL}")
        chk.expect(len(cpu[0]) > 1, f"cross {mode}: the scenario compresses ({len(cpu[0])} events)")


def numpy_params(cfg, seed: int, scale: float) -> dict:
    """Random Qwen2 weights in the JAX package's pytree layout, drawn with
    numpy so that every machine and torch version gets the same model."""
    rng = np.random.default_rng(seed)
    n_l, d, i, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    nq, nk = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1": np.ones((n_l, d), np.float32), "ln2": np.ones((n_l, d), np.float32),
              "wq": norm(n_l, d, nq), "wk": norm(n_l, d, nk), "wv": norm(n_l, d, nk), "wo": norm(n_l, nq, d),
              "w_gate": norm(n_l, d, i), "w_up": norm(n_l, d, i), "w_down": norm(n_l, i, d),
              "bq": norm(n_l, nq), "bk": norm(n_l, nk), "bv": norm(n_l, nk)}
    return {"embed": norm(cfg.vocab_size, d), "layers": layers, "final_norm": np.ones(d, np.float32),
            "lm_head": norm(d, cfg.vocab_size)}


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def phase_full(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_params_int8
    from framefusion_tpu_torch.runtime.engine import CompressionEngine

    cfg = qwen2_7b_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + params["embed"].numel() + params["lm_head"].numel()
    log(f"  random Qwen2-7B weights: {n_params / 1e9:.2f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    log(f"  prompt: {len(pt)} tokens, {n_img} image tokens at {img_start}")
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to("cuda", torch.bfloat16), patch_type=pt,
                           position_ids=np.arange(len(pt)), patch_num=182, image_token_start=img_start,
                           image_token_length=n_img)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), 0.3, 0.6, 0.1)
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup}

    for w in wrappers.values():
        w.launches = 0
    toks, res = model.generate(inputs, max_new_tokens=8)
    torch.cuda.synchronize()
    for name, w in wrappers.items():
        kernels[name]["launches"] = w.launches
    for name in wrappers:
        chk.expect(kernels[name]["launches"] > 0, f"{name}: {kernels[name]['launches']} launches in the fused run")

    ev = [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]
    log(f"  fused: events {ev}")
    log(f"  fused: final length {res.valid_len} of {len(pt)}, tail from layer {res.telemetry.tail_start_layer}, "
        f"vision-token reduction {res.telemetry.vision_token_reduction:.4f}, tokens {toks}")
    chk.expect(bool(torch.isfinite(res.logits).all()) and res.logits.shape == (cfg.vocab_size,),
               "fused: last-token logits finite, shape (vocab,)")
    chk.expect(len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks), "fused: 8 tokens in the vocabulary")
    chk.expect(res.valid_len < len(pt) and any(e.kind == "prune" or e.kind == "merge_capped" for e in res.telemetry.events),
               "fused: the prompt was compressed to the cost budget")

    eng = model.engine()
    args = (inputs.input_embeds, pt, inputs.position_ids, 182, img_start, n_img)
    res_p = eng.prefill(*args, mode="planned")
    toks_p = eng.generate(res_p, 8)
    ev_p = [(e.layer, e.kind, e.tokens_removed) for e in res_p.telemetry.events]
    log(f"  planned: mode {res_p.mode} ({res_p.plan_source}), events {ev_p}, final length {res_p.valid_len}, tokens {toks_p}")
    chk.expect(res_p.mode == "planned", "planned: mode == 'planned'")
    chk.expect(ev_p == ev and res_p.valid_len == res.valid_len, "planned: same events and final length as fused")
    chk.expect(bool(torch.isfinite(res_p.logits).all()), "planned: logits finite")

    res_d = eng.dense_prefill(inputs.input_embeds, inputs.position_ids)
    toks_d = eng.generate(res_d, 8)
    log(f"  dense: tokens {toks_d}")
    chk.expect(bool(torch.isfinite(res_d.logits).all()), "dense: logits finite")
    del res_d

    t_dense = cuda_time_ms(lambda: eng.dense_prefill(inputs.input_embeds, inputs.position_ids), iters=3, warmup=1)
    t_fused = cuda_time_ms(lambda: eng.prefill(*args, mode="fused"), iters=3, warmup=1)
    t_plan = cuda_time_ms(lambda: eng.prefill(*args, mode="planned"), iters=3, warmup=1)
    t_gen = cuda_time_ms(lambda: eng.generate(res_p, 8), iters=3, warmup=1)
    log(f"  prefill ms (CUDA events, mean of 3): dense {t_dense:.2f}, fused {t_fused:.2f}, planned {t_plan:.2f}")
    log(f"  decode: generate(8) {t_gen:.2f} ms = {t_gen / 7:.2f} ms per decode step (7 steps after the prefill token)")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Weight-only int8 decode (the JAX bench's decode configuration): the
    # layer weights become int8 pairs in place, so this runs last.
    params_q = quantize_params_int8(params)
    eng_q = CompressionEngine(params_q, cfg, eng.ff)
    launches = (mv.gemv_stacked.launches, mv.gemv_gateup.launches)
    toks_q = eng_q.generate(res_p, 8)
    chk.expect(mv.gemv_stacked.launches > launches[0] and mv.gemv_gateup.launches > launches[1]
               and len(toks_q) == 8 and all(0 <= t < cfg.vocab_size for t in toks_q),
               f"int8 decode through the int8 gemv kernels: tokens {toks_q}")
    t_gen_q = cuda_time_ms(lambda: eng_q.generate(res_p, 8), iters=3, warmup=1)
    log(f"  int8 decode: generate(8) {t_gen_q:.2f} ms = {t_gen_q / 7:.2f} ms per decode step")


class StubTokenizer:
    """Character-level ids below 101: prompts without a tokenizer file."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 101 for c in text][:40]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


QUESTION = "What happens in the video?"


def numpy_vit_params(vcfg, seed: int, scale: float, resid_scale: float) -> dict:
    """Random SigLIP weights in the JAX package's pytree layout, drawn with
    numpy; the blocks write to the residual stream at ``resid_scale``."""
    rng = np.random.default_rng(seed)
    n_l, d, i = vcfg.num_layers, vcfg.hidden_size, vcfg.intermediate_size

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": np.ones((n_l, d), np.float32), "ln1_b": norm(n_l, d),
              "ln2_w": np.ones((n_l, d), np.float32), "ln2_b": norm(n_l, d),
              "wq": norm(n_l, d, d), "bq": norm(n_l, d), "wk": norm(n_l, d, d), "bk": norm(n_l, d),
              "wv": norm(n_l, d, d), "bv": norm(n_l, d), "wo": norm(n_l, d, d), "bo": norm(n_l, d),
              "w_fc1": norm(n_l, d, i), "b_fc1": norm(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": norm(n_l, d)}
    for name in ("wo", "bo", "w_fc2", "b_fc2"):
        layers[name] *= np.float32(resid_scale / scale)
    return {"patch_kernel": norm(vcfg.patch_size, vcfg.patch_size, 3, d), "patch_bias": norm(d),
            "pos_embed": norm(vcfg.num_patches, d), "layers": layers,
            "post_ln_w": np.ones(d, np.float32), "post_ln_b": np.zeros(d, np.float32)}


def numpy_projector(vision_dim: int, llm_dim: int, seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((vision_dim, llm_dim), dtype=np.float32) * np.float32(scale),
            "b1": np.zeros(llm_dim, np.float32),
            "w2": rng.standard_normal((llm_dim, llm_dim), dtype=np.float32) * np.float32(scale),
            "b2": np.zeros(llm_dim, np.float32),
            "image_newline": rng.standard_normal(llm_dim, dtype=np.float32) * np.float32(scale)}


def coherent_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """uint8 (n, h, w, 3) video: each frame drifts from the last
    (``bench.py``'s coherent synthetic pixels, mapped to 8 bits)."""
    fr = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    for f in range(1, n):
        fr[f] = fr[f - 1] * 0.98 + 0.2 * rng.standard_normal((h, w, 3), dtype=np.float32)
    return np.clip(128 + 40 * fr, 0, 255).astype(np.uint8)


def half_static_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """uint8 (n, h, w, 3) video whose left half stands still and whose right
    half is new in every frame: with a tower that mixes patches little,
    adjacent-frame similarities fall far from the threshold on either side,
    so bf16 roundings do not flip a merge."""
    frames = np.repeat(rng.integers(0, 256, (1, h, w, 3)), n, axis=0)
    frames[:, :, w // 2 :] = rng.integers(0, 256, (n, h, w - w // 2, 3))
    return frames.astype(np.uint8)


def tiny_vision_run(device: str, dtype: torch.dtype):
    """The tiny pixels-to-answer run of phase 5 on one device: (frontend
    features fp32 on the CPU, events, cache lengths, tokens, E launches)."""
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import llava_frontend, siglip
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.pipeline import TextPipeline

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=dtype)
    vcfg = siglip.ViTConfig(image_size=56, patch_size=7, hidden_size=288, intermediate_size=576, num_layers=3,
                            num_heads=4, dtype=dtype)  # head dim 72, as so400m's
    params = _cast_floats(qwen2.params_from_numpy(numpy_params(cfg, seed=0, scale=0.05), device), dtype)
    vit = _cast_floats(siglip.params_from_numpy(numpy_vit_params(vcfg, seed=1, scale=0.05, resid_scale=0.005),
                                                device), dtype)
    proj = _cast_floats(llava_frontend.params_from_numpy(
        numpy_projector(vcfg.hidden_size, cfg.hidden_size, seed=2, scale=0.05), device), dtype)
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=params), 0.3, 0.95, 0.1)
    model.ff = model.ff.replace(schedule_num_layers=cfg.num_layers, bucket=32)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    frames = half_static_frames(np.random.default_rng(6), 12, 45, 61)
    launches = ba.bidir_attn_fwd.launches
    feats = llava_frontend.encode_video(vit, vcfg, proj, pipe._prepare_frames(frames))
    toks = [int(t) for t in pipe.ask(QUESTION, frames=frames, max_new_tokens=8).split()]
    res = pipe.last_result
    return (feats.float().cpu(), [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
            [c[2] for c in res.layer_caches], toks, ba.bidir_attn_fwd.launches - launches)


def phase_cross_vision(chk: Checks) -> None:
    cpu = tiny_vision_run("cpu", torch.bfloat16)
    gpu = tiny_vision_run("cuda", torch.bfloat16)
    rel = float((cpu[0] - gpu[0]).abs().max() / cpu[0].abs().max())
    log(f"  cpu events {cpu[1]} tokens {cpu[3]}; cuda events {gpu[1]} tokens {gpu[3]}")
    chk.expect(rel <= FEATURE_RTOL, f"cross vision: frontend features differ by {rel:.3e} of their largest "
                                    f"<= {FEATURE_RTOL}")
    chk.expect(cpu[1] == gpu[1] and cpu[2] == gpu[2], "cross vision: events and cache lengths equal")
    chk.expect(cpu[3] == gpu[3], "cross vision: greedy tokens equal")
    chk.expect(len(set(gpu[3])) >= 3, f"cross vision: the tokens vary ({len(set(gpu[3]))} distinct of 8)")
    chk.expect(len(cpu[1]) > 1, f"cross vision: the scenario compresses ({len(cpu[1])} events)")
    chk.expect(cpu[4] == 0 and gpu[4] > 0, f"cross vision: kernel E launched on the card only ({gpu[4]} launches)")


def phase_pixels(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch import native, preprocess
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.vision import llava_frontend, siglip
    from framefusion_tpu_torch.ops.kernels import bidir_attention as ba
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.pipeline import TextPipeline

    t0 = time.perf_counter()
    native.load(required=True)
    log(f"  native preprocessing built and loaded in {time.perf_counter() - t0:.1f} s")
    cfg = qwen2_7b_config()
    vcfg = siglip.ViTConfig(dtype=torch.bfloat16)  # so400m@384/14: 27 layers, 1152 wide, 16 heads
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    vit = siglip.init_params(vcfg, torch.Generator(device="cuda").manual_seed(1))
    proj = llava_frontend.init_projector(torch.Generator(device="cuda").manual_seed(2), vcfg.hidden_size,
                                         cfg.hidden_size, dtype=torch.bfloat16)
    frames = coherent_frames(np.random.default_rng(0), 64, 360, 480)
    pre = preprocess.preprocess_frames(frames[:2], "llava_video", target=(384, 384), impl="native")
    pre_np = preprocess.preprocess_frames(frames[:2], "llava_video", target=(384, 384), impl="numpy")
    perr = float(np.abs(pre - pre_np).max())
    chk.expect(pre.shape == (2, 384, 384, 3) and perr <= 1e-4,
               f"native preprocessing 360x480 -> 384x384 equals numpy's within 1e-4 ({perr:.2e})")

    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params,
                             vision={"kind": "siglip", "cfg": vcfg, "params": vit, "projector": proj})
    pipes = {"framefusion": apply_framefusion(model, 0.3, 0.6, 0.1), "dense": model}
    pipes = {k: TextPipeline(model=m, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
             for k, m in pipes.items()}
    inputs = pipes["framefusion"].build_inputs(QUESTION, frames=frames)
    chk.expect(inputs.image_token_length == 64 * 182 and inputs.patch_num == 182,
               f"prompt: {inputs.image_token_length} vision tokens (64 x 182) of {inputs.input_embeds.shape[0]}")
    chk.expect(bool(torch.isfinite(inputs.input_embeds).all()), "prompt embeddings finite")
    del inputs

    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "bidir_attn_fwd": ba.bidir_attn_fwd}
    for w in wrappers.values():
        w.launches = 0
    answer = pipes["framefusion"].ask(QUESTION, frames=frames, max_new_tokens=8)
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    kernels["bidir_attn_fwd"]["launches"] = counts["bidir_attn_fwd"]
    log(f"  framefusion ask: launches {counts}")
    n_enc = (vcfg.num_layers - 1) * 4  # feature layer -2 runs 26 blocks, 4 batches of 16 frames
    chk.expect(counts["bidir_attn_fwd"] == n_enc, f"bidir_attn_fwd: {counts['bidir_attn_fwd']} launches in the "
                                                 f"pixels-to-answer run (26 layers x 4 batches = {n_enc})")
    res = pipes["framefusion"].last_result
    toks = [int(t) for t in answer.split()]
    ev = [(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]
    for name, n in counts.items():
        if name == "bidir_attn_fwd":
            continue  # held to its exact count above
        if name == "attn_importance_rows" and not any(e[1] == "prune" for e in ev):
            log(f"  attn_importance_rows: {n} launches (no prune event in this run: kernel B is not on its path)")
            continue
        chk.expect(n > 0, f"{name}: {n} launches in the pixels-to-answer run")
    log(f"  framefusion: events {ev}, final length {res.valid_len}, vision-token reduction "
        f"{res.telemetry.vision_token_reduction:.4f}, tokens {toks}")
    chk.expect(bool(torch.isfinite(res.logits).all()) and len(toks) == 8
               and all(0 <= t < cfg.vocab_size for t in toks), "framefusion: logits finite, 8 tokens in the vocabulary")
    chk.expect(len(ev) > 0 and res.valid_len < 11648, "framefusion: the prompt was compressed")
    answer_d = pipes["dense"].ask(QUESTION, frames=frames, max_new_tokens=8)
    toks_d = [int(t) for t in answer_d.split()]
    log(f"  dense: tokens {toks_d}")
    chk.expect(bool(torch.isfinite(pipes["dense"].last_result.logits).all()) and len(toks_d) == 8,
               "dense: logits finite, 8 tokens")

    pre_all = pipes["framefusion"]._prepare_frames(frames)
    feats = llava_frontend.encode_video(vit, vcfg, proj, pre_all)
    t_enc = cuda_time_ms(lambda: llava_frontend.encode_video(vit, vcfg, proj, pre_all), iters=3, warmup=1)
    t_ff = cuda_time_ms(lambda: pipes["framefusion"].ask(QUESTION, frames=frames, max_new_tokens=8), iters=3, warmup=1)
    t_dense = cuda_time_ms(lambda: pipes["dense"].ask(QUESTION, frames=frames, max_new_tokens=8), iters=3, warmup=1)
    log(f"  encode ms (64 frames, preprocessed; CUDA events, mean of 3): {t_enc:.2f}")
    log(f"  pixels-to-answer ms (64 uint8 frames -> 8 tokens; CUDA events, mean of 3): framefusion {t_ff:.2f}, "
        f"dense {t_dense:.2f}, dense / framefusion {t_dense / t_ff:.3f}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The W8A8 tower: the tower's stacks become int8 pairs in place, so this runs last.
    siglip.quantize_tower_int8(vit)
    feats_q = llava_frontend.encode_video(vit, vcfg, proj, pre_all, w8a8=True)
    cos = torch.nn.functional.cosine_similarity(feats_q.float().flatten(), feats.float().flatten(), dim=0).item()
    t_enc_q = cuda_time_ms(lambda: llava_frontend.encode_video(vit, vcfg, proj, pre_all, w8a8=True),
                           iters=3, warmup=1)
    log(f"  W8A8 tower: encode {t_enc_q:.2f} ms (bf16 {t_enc:.2f}), cosine to the bf16 features {cos:.5f}")
    chk.expect(feats_q.shape == feats.shape and bool(torch.isfinite(feats_q).all()),
               "W8A8 tower: features finite, same shape")


def baseline_methods(n_layers: int) -> dict:
    """The paper's comparison methods with ``scripts/example_baselines.py``'s
    settings: name -> (replace_forward mode, its keyword arguments)."""
    return {
        "fastv": ("fastv", dict(fastv_k=3, fastv_r=0.5)),
        "streamingllm": ("streamingllm", dict(init_num=8, length_rate=0.3)),
        "prefill_merge": ("prefill_merge", dict(sparsity=[0.1] * n_layers)),
        "merge_then_fastv": ("merge_then_fastv", dict(sparsity=[0.1] * n_layers, fastv_k=3, fastv_r=0.5)),
        "fastv_then_merge": ("fastv_then_merge", dict(fastv_k=2, fastv_r=0.75, merging_sparsity=0.3)),
        "streamingllm_sink_decode": ("streamingllm", dict(init_num=8, length_rate=0.3, sink_cache_decode=True)),
    }


def readout_params(cfg, seed: int, resid_scale: float) -> dict:
    """``numpy_params`` with a decisive readout: embeddings of unit scale, an
    LM head whose column j is embedding perm[j] (so a token's successor is
    fixed, by a logit margin of over half the largest logit), and blocks
    that write to the residual stream at ``resid_scale``. Greedy tokens then
    survive any bf16 rounding, while attention and compression still move
    the logits by far more than the bf16 bound."""
    tree = numpy_params(cfg, seed=seed, scale=0.05)
    tree["embed"] *= np.float32(20.0)
    perm = np.random.default_rng(seed + 1).permutation(cfg.vocab_size)
    tree["lm_head"] = np.ascontiguousarray(tree["embed"][perm].T) / np.float32(20.0)
    for name in ("wo", "w_down"):
        tree["layers"][name] *= np.float32(resid_scale / 0.05)
    return tree


def tiny_baselines_run(device: str, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every baseline method through replace_forward + generate(8) on the
    tiny geometry of phase 3 with ``readout_params`` weights, on a 331-token
    prompt (40 frames x 8 patches, ending in a vocabulary token) whose merges
    and prunes cross bucket bounds. Returns name -> (events, cache lengths,
    tokens, prefill logits fp32 on the CPU, the sink-cache decode's last
    logits fp32 on the CPU or None), and the number of kernel F launches
    under "F"."""
    from framefusion_tpu_torch.baselines import replace_forward
    from framefusion_tpu_torch.config import tiny_llm_config
    from framefusion_tpu_torch.interface import FrameFusionModel
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=dtype)
    tree = readout_params(cfg, seed=0, resid_scale=0.03)
    params = _cast_floats(qwen2.params_from_numpy(tree, device), dtype)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=40,
                                                 patch_num=8, n_pre=6, n_post=5)
    h[-1] = tree["embed"][7]
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h), patch_type=pt, position_ids=np.arange(len(pt)),
                           patch_num=8, image_token_start=img_start, image_token_length=n_img)
    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
    launches = sp.sink_attn_fwd.launches
    out = {}
    for name, (mode, kw) in baseline_methods(cfg.num_layers).items():
        m = replace_forward(model, mode, **kw)
        toks, res = m.generate(inputs, max_new_tokens=8)
        decode_logits = m.engine().sink_cache_decode(res, 8)[1].float().cpu() if kw.get("sink_cache_decode") else None
        out[name] = ([(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events],
                     [c[2] for c in res.layer_caches], toks, res.logits.float().cpu(), decode_logits)
    out["F"] = sp.sink_attn_fwd.launches - launches
    return out


def phase_cross_baselines(chk: Checks) -> None:
    """Every method on the CPU (plain versions) and on the card (kernels).
    With ``readout_params`` the greedy tokens hold by construction, so the
    token check only guards against a gross fault; the logits bounds are the
    checks that can fail: the prefill's for every method, and the last decode
    step's for the sink-cache decode, which shows in nothing else."""
    cpu = tiny_baselines_run("cpu")
    gpu = tiny_baselines_run("cuda")
    for name in baseline_methods(6):
        c, g = cpu[name], gpu[name]
        rel = float((c[3] - g[3]).abs().max() / c[3].abs().max())
        log(f"  {name}: events {g[0]}, cache lengths {g[1]}; cpu tokens {c[2]}, cuda tokens {g[2]}")
        chk.expect(c[0] == g[0] and c[1] == g[1], f"cross {name}: events and cache lengths equal")
        chk.expect(c[2] == g[2], f"cross {name}: greedy tokens equal")
        chk.expect(rel <= LOGIT_RTOL, f"cross {name}: prefill logits differ by {rel:.3e} of their largest "
                                      f"<= {LOGIT_RTOL}")
        if c[4] is not None:
            rel_d = float((c[4] - g[4]).abs().max() / c[4].abs().max())
            chk.expect(rel_d <= LOGIT_RTOL, f"cross {name}: the last decode step's logits differ by {rel_d:.3e} of "
                                            f"their largest <= {LOGIT_RTOL}")
    chk.expect(cpu["F"] == 0 and gpu["F"] == 12, f"cross: kernel F launched on the card only, once per layer of "
                                                 f"the two StreamingLLM prefills ({cpu['F']}, {gpu['F']})")


def phase_baselines(chk: Checks, kernels: dict) -> None:
    """The paper's method comparison at full width: random Qwen2-7B weights
    (bf16, drawn afresh: phase 4 quantized its own), the 64-frame prompt,
    every method's prefill and 8 greedy tokens."""
    from framefusion_tpu_torch.baselines import replace_forward
    from framefusion_tpu_torch.config import qwen2_7b_config
    from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
    from framefusion_tpu_torch.models import qwen2
    from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.kernels import sink_prefill as sp
    from framefusion_tpu_torch.ops.rope import apply_rope

    cfg = qwen2_7b_config()
    torch.cuda.reset_peak_memory_stats()
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size)
    inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to("cuda", torch.bfloat16), patch_type=pt,
                           position_ids=np.arange(len(pt)), patch_num=182, image_token_start=img_start,
                           image_token_length=n_img)
    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
    methods = {"dense": model, "framefusion": apply_framefusion(model, 0.3, 0.6, 0.1)}
    methods.update({name: replace_forward(model, mode, **kw) for name, (mode, kw) in
                    baseline_methods(cfg.num_layers).items()})
    wrappers = {"flash_attn_fwd": fp.flash_attn_fwd, "attn_importance_rows": fp.attn_importance_rows,
                "gemv_stacked": mv.gemv_stacked, "gemv_gateup": mv.gemv_gateup, "sink_attn_fwd": sp.sink_attn_fwd}

    for w in wrappers.values():
        w.launches = 0
    results = {}
    for name, m in methods.items():
        f0 = sp.sink_attn_fwd.launches
        res = m.prefill(inputs)
        torch.cuda.synchronize()
        if getattr(m.engine(), "mode", None) == "streamingllm":
            n_f = sp.sink_attn_fwd.launches - f0
            chk.expect(n_f == cfg.num_layers, f"{name}: {n_f} kernel F launches in the prefill (one per layer)")
        toks = m.engine().generate(res, 8)
        results[name] = (res, toks)
    torch.cuda.synchronize()
    counts = {name: w.launches for name, w in wrappers.items()}
    kernels["sink_attn_fwd"]["launches"] = counts["sink_attn_fwd"]
    log(f"  launches over the eight methods' prefill + generate(8): {counts}")
    for name, n in counts.items():
        chk.expect(n > 0, f"{name}: {n} launches in the method comparison")

    # Kernel F on the tensors the StreamingLLM prefill gives it: layer 0's
    # q, k, v at the bucket-padded length, with the prefill's sink and window.
    eng = methods["streamingllm"].engine()
    h0, _, pos0, _ = eng._prep_inputs(inputs.input_embeds, pt, inputs.position_ids)
    lp = qwen2.layer_slice(params["layers"], 0)
    q, k, v = qwen2._project_qkv(lp, qwen2.rmsnorm(h0, lp["ln1"], cfg.rms_norm_eps), cfg)
    q, k = apply_rope(q, k, *qwen2.positions_cos_sin(pos0, cfg))
    window = int(0.3 * len(pt)) - 8
    out, ref = sp.sink_attn_fwd(q, k, v, 8, window).float(), sp.sink_attn_fwd_plain(q, k, v, 8, window).float()
    err_rh = (out - ref).abs().amax(-1)
    rel = (err_rh / ref.abs().amax(-1).clamp(min=1e-30)).max().item()
    _max_err(kernels["sink_attn_fwd"], err_rh.max().item())
    chk.expect(rel <= ATTN_ROW_RTOL, f"F on the StreamingLLM prefill's layer-0 q, k, v (S={q.shape[0]}, window "
                                     f"{window}): max_abs_err {err_rh.max().item():.3e}; per (row, head) error / its "
                                     f"largest output: max {rel:.3e} <= {ATTN_ROW_RTOL}")
    del h0, q, k, v, out, ref, err_rh

    for name, m in methods.items():
        res, toks = results[name]
        t_pre = cuda_time_ms(lambda: m.prefill(inputs), iters=3, warmup=1)
        tel = res.telemetry
        reduction = tel.vision_token_reduction if tel is not None else 0.0
        log(f"  {name}: prefill {t_pre:.2f} ms (CUDA events, mean of 3), tokens kept {res.valid_len} of {len(pt)}, "
            f"vision-token reduction {reduction:.4f}, tokens {toks}")
        chk.expect(bool(torch.isfinite(res.logits).all()) and res.logits.shape == (cfg.vocab_size,)
                   and len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks),
                   f"{name}: logits finite, 8 tokens in the vocabulary")
    t_gen = cuda_time_ms(lambda: methods["streamingllm_sink_decode"].engine().generate(
        results["streamingllm_sink_decode"][0], 8), iters=3, warmup=1)
    log(f"  sink-cache decode: generate(8) {t_gen:.2f} ms = {t_gen / 7:.2f} ms per decode step")

    # A window over the whole prompt makes the sink mask causal: the first
    # token must be dense's.
    # FastV keeping every token is a causal prefill (kernel A) at the same
    # padded length as StreamingLLM's.
    full = replace_forward(model, "streamingllm", init_num=8, length_rate=1.0).prefill(inputs)
    causal = replace_forward(model, "fastv", fastv_k=3, fastv_r=0.0).prefill(inputs)
    dense = results["dense"][0].logits
    rel = float((full.logits - dense).abs().max() / dense.abs().max())
    rel_c = float((full.logits - causal.logits).abs().max() / causal.logits.abs().max())
    top2 = torch.topk(dense, 2).values
    tok_s, tok_d = int(torch.argmax(full.logits)), int(torch.argmax(dense))
    chk.expect(tok_s == tok_d, f"streamingllm length_rate 1.0: first token {tok_s} == dense's {tok_d} (logits "
                               f"differ by {rel:.3e} of their largest; dense's top-2 margin "
                               f"{float(top2[0] - top2[1]):.4f})")
    chk.expect(rel_c <= LOGIT_RTOL, f"streamingllm length_rate 1.0: logits differ from the causal prefill at the "
                                    f"same padded length (FastV keeping every token) by {rel_c:.3e} <= {LOGIT_RTOL}")
    log(f"  max_memory_allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card and never runs on the CPU",
              file=sys.stderr)
        return 1
    try:
        import framefusion_tpu_torch  # noqa: F401  (the port must be beside this script)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = Checks()
    kernels = {
        "flash_attn_fwd": {"replaces": "framefusion_tpu/ops/kernels/flash_prefill.py:719",
                           "source": "framefusion_tpu_torch/csrc/flash_prefill.cu"},
        "attn_importance_rows": {"replaces": "framefusion_tpu/ops/kernels/flash_prefill.py:603",
                                 "source": "framefusion_tpu_torch/csrc/flash_prefill.cu"},
        "gemv_stacked": {"replaces": "framefusion_tpu/ops/kernels/matvec_q8.py:171",
                         "source": "framefusion_tpu_torch/csrc/matvec.cu"},
        "gemv_gateup": {"replaces": "framefusion_tpu/ops/kernels/matvec_q8.py:333",
                        "source": "framefusion_tpu_torch/csrc/matvec.cu"},
        "bidir_attn_fwd": {"replaces": "framefusion_tpu/ops/kernels/bidir_attention.py:72",
                           "source": "framefusion_tpu_torch/csrc/bidir_attention.cu"},
        "sink_attn_fwd": {"replaces": "framefusion_tpu/ops/kernels/sink_prefill.py:102",
                          "source": "framefusion_tpu_torch/csrc/sink_prefill.cu"},
    }
    for k in kernels.values():  # every number is filled in by this run's phases
        k.update(route="cuda", launches=None, max_abs_err=None, ms=None, plain_ms=None)
    phases = {"device": lambda: phase_device(chk), "kernels": lambda: phase_kernels(chk, kernels),
              "cross": lambda: phase_cross(chk), "full": lambda: phase_full(chk, kernels),
              "cross_vision": lambda: phase_cross_vision(chk), "pixels": lambda: phase_pixels(chk, kernels),
              "cross_baselines": lambda: phase_cross_baselines(chk),
              "baselines": lambda: phase_baselines(chk, kernels)}
    t_start = time.perf_counter()
    for phase, run in phases.items():
        log(f"== {phase} ({time.perf_counter() - t_start:.1f} s)")
        try:
            run()
        except Exception as exc:  # a failed phase is reported, then the run fails
            import traceback

            traceback.print_exc()
            chk.failures.append(f"phase {phase} raised {type(exc).__name__}: {exc}")
        torch.cuda.synchronize()
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    unmeasured = [f"{n}.{f}" for n, k in kernels.items() for f, v in k.items() if v is None]
    chk.expect(not unmeasured, f"every number of the kernels line was measured in this run (missing: {unmeasured})")
    if chk.failures:
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    print(json.dumps({"kernels": [dict(name=n, **v) for n, v in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
