"""LLaVA-Video vision frontend: ViT features -> LLM-ready video tokens
(port of ``framefusion_tpu.models.vision.llava_frontend``).

Encode frames with the vision tower (penultimate layer), project to the LLM
width with a 2-layer GELU MLP, 2x2 average-pool the spatial grid, and append
one learned ``image_newline`` token per pooled row: ``pooled_side *
(pooled_side + 1)`` tokens per frame (182 for so400m@384/14: 27x27 -> 13x13
plus a newline column), the ``patch_num`` the adapter expects.
"""

from __future__ import annotations

import torch

from . import siglip
from ..qwen2 import params_from_numpy  # noqa: F401  (the projector's dict carries over alike)


def init_projector(generator: torch.Generator, vision_dim: int, llm_dim: int, dtype=torch.float32,
                   device=None) -> dict:
    """Random-normal projector (scale 0.02) drawn from ``generator``."""
    device = torch.device(device) if device is not None else generator.device

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(0.02)

    return {
        "w1": norm(vision_dim, llm_dim),
        "b1": torch.zeros((llm_dim,), device=device, dtype=dtype),
        "w2": norm(llm_dim, llm_dim),
        "b2": torch.zeros((llm_dim,), device=device, dtype=dtype),
        "image_newline": norm(llm_dim),
    }


def project(proj: dict, feats: torch.Tensor) -> torch.Tensor:
    """Two-layer MLP with the exact (erf) GELU. Mixed dtypes promote as in
    JAX: bf16 tower features meet an fp32 projector in fp32."""
    dt = torch.promote_types(feats.dtype, proj["w1"].dtype)
    x = feats.to(dt) @ proj["w1"].to(dt) + proj["b1"].to(dt)
    return torch.nn.functional.gelu(x, approximate="none") @ proj["w2"].to(dt) + proj["b2"].to(dt)


def pool_2d(feats: torch.Tensor, side: int, stride: int = 2):
    """(B, side*side, D) -> ((B, side//stride, side//stride, D), side//stride): average pooling."""
    b, n, d = feats.shape
    if n != side * side:
        raise ValueError(f"{n} features are not a {side}x{side} grid")
    pooled_side = side // stride
    grid = feats.reshape(b, side, side, d)[:, : pooled_side * stride, : pooled_side * stride]
    grid = grid.reshape(b, pooled_side, stride, pooled_side, stride, d).mean(dim=(2, 4))
    return grid, pooled_side


def encode_video(vit_params: dict, vit_cfg: siglip.ViTConfig, proj: dict, frames, feature_layer: int = -2,
                 pool_stride: int = 2, frame_batch: int = 16, attn_impl: str = "flash",
                 w8a8: bool = False) -> torch.Tensor:
    """(n_frames, H, W, 3) pixels -> (n_frames * patch_num, llm_dim) tokens
    on the tower's device.

    Frames are encoded ``frame_batch`` at a time (and moved to the device a
    batch at a time): the tower's activations for 64 frames at 384 px need
    not sit beside a resident 7B LLM. ``w8a8`` rides int8 encoder matmuls
    (siglip.quantize_tower_int8 params required).
    """
    frames = torch.as_tensor(frames)

    def encode_batch(batch):
        feats = siglip.encode(vit_params, batch, vit_cfg, feature_layer=feature_layer, attn_impl=attn_impl,
                              w8a8=w8a8)
        feats = project(proj, feats)
        grid, ps = pool_2d(feats, vit_cfg.patches_per_side, pool_stride)
        b, d = grid.shape[0], grid.shape[-1]
        newline = proj["image_newline"].expand(b, ps, 1, d).to(grid.dtype)
        with_newline = torch.cat([grid, newline], dim=2)  # (B, ps, ps + 1, D)
        return with_newline.reshape(b * ps * (ps + 1), d)

    n = frames.shape[0]
    if n <= frame_batch:
        return encode_batch(frames)
    return torch.cat([encode_batch(frames[i : i + frame_batch]) for i in range(0, n, frame_batch)])
