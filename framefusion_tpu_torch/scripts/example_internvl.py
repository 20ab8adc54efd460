"""InternVL2.5 A/B example on one H100: the interleaved ``FrameN: <image>``
prompt with FrameFusion (the reference's default S_th 0.5; the
InternLM2-style backbone has no qkv bias).

The default frontend runs raw pixel frames through the port's InternViT and
pixel-shuffle projector (``models/vision/internvl_vit``, kernel E on the
card); ``--precomputed-features`` uses synthetic frame embeddings instead.

Usage:
    python -m framefusion_tpu_torch.scripts.example_internvl [--num-frames 16] [--precomputed-features]
    python -m framefusion_tpu_torch.scripts.example_internvl --device cpu
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
    from ..models.adapters import internvl

    rng = np.random.default_rng(0)
    loaded = None
    if args.checkpoint:
        from ..weights import load_checkpoint

        loaded = load_checkpoint(args.checkpoint, family="internvl", device=device)
        cfg, params = loaded.cfg, loaded.params
    else:
        cfg = tiny_config(device, num_layers=8, hidden_size=256, num_heads=8, num_kv_heads=4,
                          qkv_bias=False)  # InternLM2 has no qkv bias
        params = qwen2.init_params(cfg, generator(device, 0))

    tpf = args.tokens_per_frame
    if not args.precomputed_features:
        from ..models.vision.internvl_vit import InternViTConfig, extract_features, init_projector
        from ..models.vision.internvl_vit import init_params as init_vit

        if loaded is not None and loaded.vision:
            vit_cfg, vit_params, proj = loaded.vision["cfg"], loaded.vision["params"], loaded.vision["projector"]
        else:
            # An 8 x 8 patch grid, pixel-shuffled to 4 x 4 = 16 tokens a frame.
            vit_cfg = InternViTConfig(image_size=112, patch_size=14, hidden_size=128, intermediate_size=256,
                                      num_layers=4, num_heads=4, text_hidden_size=cfg.hidden_size, dtype=cfg.dtype)
            vit_params = init_vit(vit_cfg, generator(device, 5))
            proj = init_projector(vit_cfg, generator(device, 6))
        img = vit_cfg.image_size
        base = rng.standard_normal((1, img, img, 3)).astype(np.float32)
        pix = np.concatenate([base + 0.03 * rng.standard_normal(base.shape).astype(np.float32)
                              for _ in range(args.num_frames)])
        feats = (extract_features(vit_params, proj, pix, vit_cfg).to(torch.float32) * 0.05).cpu().numpy()
        tpf = feats.shape[1]
        print(f"InternViT: {args.num_frames} frames -> {tpf} tokens/frame after pixel shuffle")

    # Interleaved: 5 text rows, then a frame at a time [3 text rows ("FrameN:")] + its image block.
    chunks, mask = [rng.standard_normal((5, cfg.hidden_size)) * 0.05], [False] * 5
    frame = rng.standard_normal((tpf, cfg.hidden_size)) * 0.05
    for f in range(args.num_frames):
        chunks.append(rng.standard_normal((3, cfg.hidden_size)) * 0.05)
        mask.extend([False] * 3)
        if args.precomputed_features:
            frame = frame + 0.01 * rng.standard_normal(frame.shape)
            chunks.append(frame.copy())
        else:
            chunks.append(feats[f])
        mask.extend([True] * tpf)
    chunks.append(rng.standard_normal((6, cfg.hidden_size)) * 0.05)
    mask.extend([False] * 6)
    embeds = torch.from_numpy(np.concatenate(chunks).astype(np.float32)).to(device, cfg.dtype)
    inputs = internvl.build_prefill_inputs(embeds, np.asarray(mask), tpf)
    print(f"prompt: {embeds.shape[0]} tokens, interleaved across {args.num_frames} frames "
          f"(the prune window spans the interleaved text, as the reference's)")
    model = FrameFusionModel(family="internvl", cfg=cfg, params=params)
    ff_model = apply_framefusion(model, args.cost, args.similarity_lower_bound, args.ratio_lower_bound)
    ff_model.ff = ff_model.ff.replace(schedule_num_layers=cfg.num_layers)
    return model, ff_model, inputs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--tokens-per-frame", type=int, default=16)
    p.add_argument("--cost", type=float, default=0.3)
    p.add_argument("--similarity-lower-bound", type=float, default=0.5)
    p.add_argument("--ratio-lower-bound", type=float, default=0.1)
    p.add_argument("--precomputed-features", action="store_true", help="skip the ViT; synthetic frame embeddings")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="hub-layout dir (InternLM2 fused wqkv + vision_model.* tower + mlp1 projector)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model, ff_model, inputs = build(args, device)
    ab = ab_prefill(model, ff_model, inputs)
    print_ab(ab, device)
    return ab


if __name__ == "__main__":
    main()
