"""NVILA A/B example on one H100 (the reference's default S_th 0.7): a video
prompt, or with ``--mode images`` the multi-image prompt of patch_num 1.

Usage:
    python -m framefusion_tpu_torch.scripts.example_nvila [--num-frames 16] [--mode video|images]
    python -m framefusion_tpu_torch.scripts.example_nvila --device cpu
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
    from ..models.adapters import nvila

    rng = np.random.default_rng(0)
    if args.checkpoint:
        from ..weights import load_checkpoint

        loaded = load_checkpoint(args.checkpoint, family="nvila", device=device)
        cfg, params = loaded.cfg, loaded.params
    else:
        cfg = tiny_config(device, num_layers=8, hidden_size=256, num_heads=8, num_kv_heads=4)
        params = qwen2.init_params(cfg, generator(device, 0))

    def on_device(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, cfg.dtype)

    text = on_device(rng.standard_normal((20, cfg.hidden_size)) * 0.05)
    if args.mode == "video":
        patch_num = 16
        media = np.empty((args.num_frames * patch_num, cfg.hidden_size), np.float32)
        frame = rng.standard_normal((patch_num, cfg.hidden_size)) * 0.05
        for f in range(args.num_frames):
            frame = frame + 0.01 * rng.standard_normal(frame.shape)
            media[f * patch_num:(f + 1) * patch_num] = frame
        inputs = nvila.build_prefill_inputs_video(text, on_device(media), 15, args.num_frames)
    else:
        base = rng.standard_normal((8, cfg.hidden_size)) * 0.05
        imgs = [on_device(base + 0.01 * rng.standard_normal(base.shape)) for _ in range(6)]
        inputs = nvila.build_prefill_inputs_multi_image(text, imgs, 15)
    print(f"mode={args.mode}: {inputs.input_embeds.shape[0]} tokens, patch_num={inputs.patch_num}")
    model = FrameFusionModel(family="nvila", cfg=cfg, params=params)
    ff_model = apply_framefusion(model, args.cost, args.similarity_lower_bound, args.ratio_lower_bound)
    ff_model.ff = ff_model.ff.replace(schedule_num_layers=cfg.num_layers)
    return model, ff_model, inputs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--mode", choices=["video", "images"], default="video")
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
