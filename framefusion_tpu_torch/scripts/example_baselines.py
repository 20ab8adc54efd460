"""Baseline methods against FrameFusion on the same prompt: dense,
FrameFusion, FastV, StreamingLLM, fixed-schedule merging and the two hybrids
(the reference's baseline entry points), on one H100.

Usage:
    python -m framefusion_tpu_torch.scripts.example_baselines           # small random model, 16 frames
    python -m framefusion_tpu_torch.scripts.example_baselines --full    # Qwen2-7B geometry, 64 frames
    python -m framefusion_tpu_torch.scripts.example_baselines --device cpu
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from .common import DeviceTimer, ab_table, add_device_arg, generator, resolve_device, timing_note, tiny_config


def variants(model) -> dict:
    """The compared methods on ``model``: name -> configured model."""
    from ..baselines import replace_forward
    from ..interface import apply_framefusion

    n_l = model.cfg.num_layers
    out = {
        "dense": model,
        "framefusion": apply_framefusion(model, 0.3, 0.6, 0.1),
        "fastv": replace_forward(model, "fastv", fastv_k=3, fastv_r=0.5),
        "streamingllm": replace_forward(model, "streamingllm", init_num=8, length_rate=0.3),
        "prefill_merge": replace_forward(model, "prefill_merge", sparsity=[0.1] * n_l),
        "merge_then_fastv": replace_forward(model, "merge_then_fastv", sparsity=[0.1] * n_l, fastv_k=3,
                                            fastv_r=0.5),
        "fastv_then_merge": replace_forward(model, "fastv_then_merge", fastv_k=2, fastv_r=0.75,
                                            merging_sparsity=0.3),
    }
    out["framefusion"].ff = out["framefusion"].ff.replace(schedule_num_layers=n_l)
    return out


def compare(model, inputs, reps: int = 3, keep_results: bool = False) -> tuple:
    """Every method's prefill of ``inputs`` on built ``model``, timed; each
    method's engine is freed before the next. Returns (rows, {name:
    PrefillResult} when ``keep_results``)."""
    rows, results = [], {}
    n = inputs.input_embeds.shape[0]
    for name, m in variants(model).items():
        t, res = DeviceTimer.timeit_slope(lambda m=m: m.prefill(inputs), lambda r: r.logits, rounds=reps)
        rows.append({"method": name, "prefill_ms": round(t * 1e3, 1), "tokens_kept": res.valid_len,
                     "reduction": f"{1 - res.valid_len / n:.1%}"})
        print(ab_table(rows[-1:]))
        if keep_results:
            results[name] = res
        del res
        m._engine = None  # free the method's graphs and pools before the next
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return rows, results


def build(args, device: torch.device):
    """(model, inputs) for the parsed arguments."""
    from ..config import qwen2_7b_config
    from ..interface import FrameFusionModel
    from ..models import qwen2
    from ..models.adapters import llava_video
    from ..models.adapters.common import PrefillInputs, build_video_prompt

    rng = np.random.default_rng(0)
    if args.full:
        cfg = qwen2_7b_config(vocab_size=8192)  # a cut vocabulary, as the bench's
        args.num_frames = 64
        patch_num = 182
    else:
        cfg = tiny_config(device, num_layers=8, hidden_size=256, num_heads=8, num_kv_heads=4)
        patch_num = 20
    params = qwen2.init_params(cfg, generator(device, 0))
    if args.full:
        h, patch_type, img_start, n_img = build_video_prompt(rng, cfg.hidden_size, n_frames=64,
                                                             patch_num=patch_num)
        # Uploaded once: no method's time holds the upload.
        inputs = PrefillInputs(input_embeds=torch.from_numpy(h).to(device, cfg.dtype), patch_type=patch_type,
                               position_ids=np.arange(len(patch_type), dtype=np.int32), patch_num=patch_num,
                               image_token_start=img_start, image_token_length=n_img)
    else:
        video = np.empty((args.num_frames * patch_num, cfg.hidden_size), np.float32)
        frame = rng.standard_normal((patch_num, cfg.hidden_size)) * 0.05
        for f in range(args.num_frames):
            frame = frame + 0.01 * rng.standard_normal(frame.shape)
            video[f * patch_num:(f + 1) * patch_num] = frame
        text = (rng.standard_normal((30, cfg.hidden_size)) * 0.05).astype(np.float32)
        inputs = llava_video.build_prefill_inputs(text, video, 25, num_patches_per_side=9)
        inputs.input_embeds = torch.from_numpy(inputs.input_embeds).to(device, cfg.dtype)
    return FrameFusionModel(family="llava_video", cfg=cfg, params=params), inputs


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--full", action="store_true",
                   help="Qwen2-7B geometry at 64 frames: the paper's method comparison at full scale")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model, inputs = build(args, device)
    rows, _ = compare(model, inputs)
    print()
    print(ab_table(rows))
    print(timing_note(device))
    return rows


if __name__ == "__main__":
    main()
