"""128-frame long-video A/B at full Qwen2-7B width on one H100 (int8 weights).

The reference's demo takes up to 128 frames. At 128 frames x 182 patches the
prompt is ~23.3k tokens: the dense prefill runs kernel A's blocked regime
over 28 / 4 heads at that length, against FrameFusion's compressed prefill.
The weights are weight-only int8 by default (``ops/quant.py``), the
single-card long-video deployment; ``--bf16`` keeps bf16 weights (~15 GB,
which an 80 GB card holds too).

Usage:
    python -m framefusion_tpu_torch.scripts.example_longvideo [--num-frames 128] [--bf16]
    python -m framefusion_tpu_torch.scripts.example_longvideo --device cpu   # small model, <= 16 frames
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from .common import DeviceTimer, ab_table, add_device_arg, generator, resolve_device, timing_note


def run_longvideo(engine, h, patch_type, img_start: int, n_img: int, patch_num: int = 182, reps: int = 3) -> dict:
    """Dense prefill logits (no caches kept) against the engine's compressed
    prefill of the same prompt, each timed. Returns {"rows", "dense_s",
    "ff_s", "res"}."""
    from ..models import qwen2

    n = len(patch_type)
    pos = np.arange(n, dtype=np.int32)
    pos_dev = torch.arange(n, device=engine.device)
    h = torch.as_tensor(h).to(engine.device, engine.cfg.dtype)

    def dense_logits():
        return qwen2.dense_prefill(engine.params, h, pos_dev, engine.cfg, attn_impl=engine.attn_impl,
                                   want_caches=False)[0]

    rows = []
    t_dense, _ = DeviceTimer.timeit(dense_logits, lambda x: x, reps)
    rows.append({"method": "dense", "prefill_ms": round(t_dense * 1e3, 1), "tokens": n, "reduction": "0.0%"})
    print(ab_table(rows[-1:]))
    gc.collect()
    t_ff, res = DeviceTimer.timeit(lambda: engine.prefill(h, patch_type, pos, patch_num, img_start, n_img),
                                   lambda r: r.logits, reps)
    rows.append({"method": "framefusion", "prefill_ms": round(t_ff * 1e3, 1), "tokens": res.valid_len,
                 "reduction": f"{1 - res.valid_len / n:.1%}"})
    print(ab_table(rows[-1:]))
    return {"rows": rows, "dense_s": t_dense, "ff_s": t_ff, "res": res}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=128)
    p.add_argument("--bf16", action="store_true", help="keep bf16 weights (no int8)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from ..config import FrameFusionConfig, qwen2_7b_config
    from ..models import qwen2
    from ..models.adapters.common import build_video_prompt
    from ..ops.quant import quantize_params_int8
    from ..runtime.engine import CompressionEngine

    if device.type == "cpu":
        cfg = qwen2_7b_config(vocab_size=4096, num_layers=4, hidden_size=512, intermediate_size=1024,
                              num_heads=8, num_kv_heads=2, dtype=torch.float32)
        args.num_frames = min(args.num_frames, 16)
    else:
        cfg = qwen2_7b_config(vocab_size=8192)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    params = qwen2.init_params(cfg, generator(device, 0))
    if not args.bf16:
        params = quantize_params_int8(params)
        gc.collect()

    h, patch_type, img_start, n_img = build_video_prompt(np.random.default_rng(0), cfg.hidden_size,
                                                         n_frames=args.num_frames)
    engine = CompressionEngine(params, cfg, ff, attn_impl="flash" if device.type == "cuda" else "einsum")
    out = run_longvideo(engine, h, patch_type, img_start, n_img)
    print()
    print(ab_table(out["rows"]))
    print(timing_note(device))
    print(f"speedup: {out['dense_s'] / out['ff_s']:.2f}x  frames={args.num_frames}  seq={len(patch_type)}  "
          f"weights={'bf16' if args.bf16 else 'int8'}  "
          f"events={[(e.layer, e.kind, e.tokens_removed) for e in out['res'].telemetry.events]}")
    return out


if __name__ == "__main__":
    main()
