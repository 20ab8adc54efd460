"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printed as it runs; every run makes all of them:

1. device  — the card's name and power limit (nvidia-smi), then the kernels'
             build from ``framefusion_tpu_torch/csrc`` and its time.
2. kernels — each hand-written kernel against its plain PyTorch version on
             the card, at the main path's shapes, with the stated bound, and
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

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that line. The script never runs on the CPU: without a CUDA device
it exits at once.
"""

from __future__ import annotations

import json
import math
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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    _build.load_library()


def _max_err(entry: dict, err: float) -> None:
    entry["max_abs_err"] = err if entry["max_abs_err"] is None else max(entry["max_abs_err"], err)


def _rand(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32) * scale).to(dtype)


def phase_kernels(chk: Checks, kernels: dict) -> None:
    from framefusion_tpu_torch.core import descending_rank
    from framefusion_tpu_torch.ops.attention import capture_rows
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
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
    }
    for k in kernels.values():  # every number is filled in by this run's phases
        k.update(route="cuda", launches=None, max_abs_err=None, ms=None, plain_ms=None)
    phases = {"device": lambda: phase_device(chk), "kernels": lambda: phase_kernels(chk, kernels),
              "cross": lambda: phase_cross(chk), "full": lambda: phase_full(chk, kernels)}
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
