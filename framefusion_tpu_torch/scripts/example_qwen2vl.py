"""Qwen2-VL A/B example on one H100: the mRoPE stack with FrameFusion
(the reference's default S_th 0.5; the importance of the last 4 query rows).

Two frontends:
  * default: raw pixel frames through the port's Qwen2-VL tower
    (``models/vision/qwen2_vl_vit``, kernel E on the card): pixels ->
    patches -> tower -> merged embedding rows -> compressed prefill;
  * ``--precomputed-features``: synthetic visual embeddings (no tower).

Usage:
    python -m framefusion_tpu_torch.scripts.example_qwen2vl [--num-frames 16] [--precomputed-features]
    python -m framefusion_tpu_torch.scripts.example_qwen2vl --device cpu
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
    from ..models.adapters import qwen2_vl

    rng = np.random.default_rng(0)
    loaded = None
    if args.checkpoint:
        from ..weights import load_checkpoint

        loaded = load_checkpoint(args.checkpoint, family="qwen2_vl", device=device)
        cfg, params = loaded.cfg, loaded.params
    else:
        # The small Qwen2-VL geometry: mRoPE sections (t, h, w) over head_dim / 2.
        cfg = tiny_config(device, num_layers=8, hidden_size=256, num_heads=8, num_kv_heads=4,
                          mrope_section=(4, 6, 6))
        params = qwen2.init_params(cfg, generator(device, 0))

    if args.precomputed_features:
        grid_t, grid_h, grid_w = args.num_frames, 8, 8
        patch_num = (grid_h * grid_w) // 4
        video = np.empty((grid_t * patch_num, cfg.hidden_size), np.float32)  # temporally coherent
        frame = rng.standard_normal((patch_num, cfg.hidden_size)).astype(np.float32) * 0.05
        for t in range(grid_t):
            frame = frame + 0.01 * rng.standard_normal(frame.shape).astype(np.float32)
            video[t * patch_num:(t + 1) * patch_num] = frame
        video = torch.from_numpy(video).to(device)
    else:
        from ..models.vision.qwen2_vl_vit import Qwen2VLViTConfig, encode_video, pixels_to_patches
        from ..models.vision.qwen2_vl_vit import init_params as init_vit

        if loaded is not None and loaded.vision:
            vit_cfg, vit_params = loaded.vision["cfg"], loaded.vision["params"]
        else:
            vit_cfg = Qwen2VLViTConfig(embed_dim=128, depth=4, num_heads=4, patch_size=14, mlp_ratio=2.0,
                                       hidden_size=cfg.hidden_size, dtype=cfg.dtype)
            vit_params = init_vit(vit_cfg, generator(device, 7))
        side = vit_cfg.patch_size * vit_cfg.spatial_merge_size * 4
        # Temporally coherent pixel frames: 2 raw frames a temporal patch.
        base = rng.standard_normal((1, side, side, 3)).astype(np.float32)
        frames = np.concatenate([base + 0.05 * rng.standard_normal(base.shape).astype(np.float32)
                                 for _ in range(2 * args.num_frames)])
        patches, (grid_t, grid_h, grid_w) = pixels_to_patches(frames, vit_cfg)
        video = encode_video(vit_params, patches, grid_t, grid_h, grid_w, vit_cfg).to(torch.float32) * 0.05
        print(f"ViT: {frames.shape[0]} frames -> grid ({grid_t},{grid_h},{grid_w}) -> {video.shape[0]} "
              f"embedding rows")
    text = torch.from_numpy(rng.standard_normal((30, cfg.hidden_size)).astype(np.float32) * 0.05).to(device)
    inputs = qwen2_vl.build_prefill_inputs(text, video, 25, grid_t, grid_h, grid_w)
    inputs.input_embeds = inputs.input_embeds.to(cfg.dtype)
    print(f"prompt: {inputs.input_embeds.shape[0]} tokens, 3D mRoPE positions, "
          f"importance rows: {inputs.num_importance_queries}")
    model = FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params)
    ff_model = apply_framefusion(model, args.cost, args.similarity_lower_bound, args.ratio_lower_bound)
    ff_model.ff = ff_model.ff.replace(schedule_num_layers=cfg.num_layers)
    return model, ff_model, inputs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--cost", type=float, default=0.3)
    p.add_argument("--similarity-lower-bound", type=float, default=0.5)
    p.add_argument("--ratio-lower-bound", type=float, default=0.1)
    p.add_argument("--precomputed-features", action="store_true", help="skip the ViT; synthetic visual embeddings")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="hub-layout dir (config.json + safetensors; loads the visual.* tower too)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model, ff_model, inputs = build(args, device)
    ab = ab_prefill(model, ff_model, inputs)
    print_ab(ab, device)
    return ab


if __name__ == "__main__":
    main()
