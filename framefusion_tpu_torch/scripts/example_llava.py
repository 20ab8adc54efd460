"""LLaVA-Video A/B example: dense against FrameFusion on one H100.

The reference's playground example, with its defaults (cost 0.3,
similarity_lower_bound 0.6, ratio_lower_bound 0.1, 64 frames): the same
prompt prefilled dense and compressed, then greedy tokens from each, in a
side-by-side table.

Usage:
    python -m framefusion_tpu_torch.scripts.example_llava                 # small random model
    python -m framefusion_tpu_torch.scripts.example_llava --full-size     # Qwen2-7B geometry
    python -m framefusion_tpu_torch.scripts.example_llava --checkpoint DIR --video clip.mp4
    python -m framefusion_tpu_torch.scripts.example_llava --device cpu    # on the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import (ab_prefill, ab_rows, ab_table, add_device_arg, generator, load_video_frames, resolve_device,
                     synthetic_video, timing_note, tiny_config)


def build(args, device: torch.device):
    """(model, ff_model, inputs) for the parsed arguments."""
    from ..config import qwen2_7b_config
    from ..interface import FrameFusionModel, apply_framefusion
    from ..models import qwen2
    from ..models.adapters import llava_video
    from ..models.vision import siglip
    from ..models.vision.llava_frontend import encode_video, init_projector

    rng = np.random.default_rng(0)
    vision = None
    if args.checkpoint:
        # config.json's geometry, the LLM and (when present) the SigLIP tower
        # and mm_projector of the same hub-layout directory.
        from ..weights import load_checkpoint

        loaded = load_checkpoint(args.checkpoint, family="llava_video", quantize="int8" if args.int8 else None,
                                 device=device)
        cfg, params, vision = loaded.cfg, loaded.params, loaded.vision
        vit_cfg = vision["cfg"] if vision else siglip.ViTConfig(dtype=cfg.dtype)
    elif args.full_size:
        cfg = qwen2_7b_config(vocab_size=32768)
        params = qwen2.init_params(cfg, generator(device, 0))
        if args.int8:
            from ..ops.quant import quantize_params_int8

            params = quantize_params_int8(params)
        vit_cfg = siglip.ViTConfig(num_layers=4, dtype=cfg.dtype)  # a random tower: keep the encode short
    else:
        cfg = tiny_config(device, num_layers=8, hidden_size=256, intermediate_size=512, num_heads=8)
        params = qwen2.init_params(cfg, generator(device, 0))
        vit_cfg = siglip.tiny_vit_config(image_size=56, patch_size=7, dtype=cfg.dtype)  # 8 patches a side

    if vision:
        vit = vision["params"]
        proj = vision["projector"] or init_projector(generator(device, 2), vit_cfg.hidden_size, cfg.hidden_size,
                                                     cfg.dtype)
    else:
        vit = siglip.init_params(vit_cfg, generator(device, 1))
        proj = init_projector(generator(device, 2), vit_cfg.hidden_size, cfg.hidden_size, cfg.dtype)

    if args.video:
        frames = load_video_frames(args.video, args.num_frames, vit_cfg.image_size)
    else:
        frames = synthetic_video(rng, args.num_frames, vit_cfg.image_size)

    print(f"encoding {len(frames)} frames @ {vit_cfg.image_size}px ...")
    video_tokens = encode_video(vit, vit_cfg, proj, frames).to(torch.float32) * (1.0 if args.checkpoint else 0.05)
    text = torch.from_numpy(rng.standard_normal((40, cfg.hidden_size)).astype(np.float32) * 0.05).to(device)
    inputs = llava_video.build_prefill_inputs(text, video_tokens, image_token_pos=35,
                                              num_patches_per_side=vit_cfg.patches_per_side)
    # The prompt stays on the device in the model's dtype: no upload is timed.
    inputs.input_embeds = inputs.input_embeds.to(cfg.dtype)
    print(f"prompt: {inputs.input_embeds.shape[0]} tokens "
          f"({inputs.image_token_length} video, patch_num={inputs.patch_num})")
    model = FrameFusionModel(family="llava_video", cfg=cfg, params=params)
    ff_model = apply_framefusion(model, args.cost, args.similarity_lower_bound, args.ratio_lower_bound)
    return model, ff_model, inputs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=str, default=None, help="safetensors dir (LLaVA-Video-7B-Qwen2)")
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--num-frames", type=int, default=64)
    p.add_argument("--cost", type=float, default=0.3)
    p.add_argument("--similarity-lower-bound", type=float, default=0.6)
    p.add_argument("--ratio-lower-bound", type=float, default=0.1)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--full-size", action="store_true", help="Qwen2-7B geometry with random weights")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decoder (quantized on load for --checkpoint)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    model, ff_model, inputs = build(args, device)
    ab = ab_prefill(model, ff_model, inputs, args.max_new_tokens)
    t = ab["ff"].telemetry
    print(ab_table(ab_rows(ab)))
    print(timing_note(device))
    print(f"\nspeedup: {ab['dense_s'] / ab['ff_s']:.2f}x | vision-token reduction: "
          f"{t.vision_token_reduction:.1%} | events: "
          f"{[(e.layer, e.kind, e.tokens_removed) for e in t.events]}")
    return ab


if __name__ == "__main__":
    main()
