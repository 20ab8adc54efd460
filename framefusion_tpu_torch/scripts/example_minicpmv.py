"""MiniCPM-V 2.6 A/B example on one H100 (the reference's default S_th 0.7;
the frame geometry from the image bounds, with the 2 separator slots a
frame).

Usage:
    python -m framefusion_tpu_torch.scripts.example_minicpmv [--num-frames 16] [--slice-tokens 12]
    python -m framefusion_tpu_torch.scripts.example_minicpmv --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import ab_prefill, add_device_arg, generator, print_ab, resolve_device, tiny_config


def build(args, device: torch.device):
    """(model, ff_model, inputs) for the parsed arguments."""
    from ..interface import FrameFusionModel, apply_framefusion
    from ..models import qwen2
    from ..models.adapters import minicpmv

    rng = np.random.default_rng(0)
    if args.checkpoint:
        from ..weights import load_checkpoint

        loaded = load_checkpoint(args.checkpoint, family="minicpmv", device=device)
        cfg, params = loaded.cfg, loaded.params
    else:
        cfg = tiny_config(device, num_layers=8, hidden_size=256, num_heads=8, num_kv_heads=4)
        params = qwen2.init_params(cfg, generator(device, 0))

    # 6 text rows, then a frame at a time [slice_tokens image rows + 2 separators].
    st = args.slice_tokens
    tpf = st + 2
    total = 6 + args.num_frames * tpf + 8
    embeds = (rng.standard_normal((total, cfg.hidden_size)) * 0.05).astype(np.float32)
    bounds = []
    frame = rng.standard_normal((st, cfg.hidden_size)) * 0.05
    for f in range(args.num_frames):
        lo = 6 + f * tpf
        frame = frame + 0.01 * rng.standard_normal(frame.shape)
        embeds[lo:lo + st] = frame
        bounds.append([lo, lo + st])
    inputs = minicpmv.build_prefill_inputs(torch.from_numpy(embeds).to(device, cfg.dtype), np.asarray(bounds),
                                           args.num_frames)
    print(f"prompt: {total} tokens, token_per_frame={inputs.patch_num} (the separator slots included, as the "
          f"reference's)")
    model = FrameFusionModel(family="minicpmv", cfg=cfg, params=params)
    ff_model = apply_framefusion(model, args.cost, args.similarity_lower_bound, args.ratio_lower_bound)
    ff_model.ff = ff_model.ff.replace(schedule_num_layers=cfg.num_layers)
    return model, ff_model, inputs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--slice-tokens", type=int, default=12)
    p.add_argument("--cost", type=float, default=0.3)
    p.add_argument("--similarity-lower-bound", type=float, default=0.7)
    p.add_argument("--ratio-lower-bound", type=float, default=0.1)
    p.add_argument("--checkpoint", type=str, default=None, help="hub-layout dir (config.json + safetensors)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model, ff_model, inputs = build(args, device)
    ab = ab_prefill(model, ff_model, inputs)
    print_ab(ab, device)
    return ab


if __name__ == "__main__":
    main()
