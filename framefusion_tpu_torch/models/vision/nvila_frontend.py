"""NVILA vision frontend: SigLIP features -> space-to-channel downsampled
video tokens (port of ``framefusion_tpu.models.vision.nvila_frontend``).

VILA's ``mlp_downsample`` connector: each 2x2 block of neighbouring patches
concatenates along the channels (space-to-channel), then an fp32 LayerNorm
and a two-layer exact-GELU MLP into the LLM width. The tower runs to its
penultimate layer (``feature_layer=-2``) with its attention on kernel E
(``attn_impl="flash"``); the connector's two matmuls are plain products.
"""

from __future__ import annotations

import dataclasses

import torch

from ...runtime.profiling import span
from . import siglip
from .siglip import _layernorm
# JAX's connector tree (``jax.device_get`` of its ``init_projector``) as this
# package's: the same keys, fp32 tensors on ``weights.resolve_device``'s device.
from ..qwen2 import params_from_numpy as projector_from_numpy  # noqa: F401


@dataclasses.dataclass(frozen=True)
class NvilaProjectorConfig:
    vision_dim: int = 1152
    llm_dim: int = 3584
    pool: int = 2  # space-to-channel factor
    dtype: torch.dtype = torch.float32


def init_projector(cfg: NvilaProjectorConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal connector (scale 0.02, LayerNorm at 1 / 0) drawn from
    ``generator`` in ``cfg.dtype`` on ``device`` (the generator's device by
    default)."""
    device = torch.device(device) if device is not None else generator.device
    din = cfg.vision_dim * cfg.pool * cfg.pool

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(0.02)

    def const(n, value):
        return torch.full((n,), value, device=device, dtype=cfg.dtype)

    w1 = norm(din, cfg.llm_dim)
    return {"ln_w": const(din, 1.0), "ln_b": const(din, 0.0), "w1": w1, "b1": const(cfg.llm_dim, 0.0),
            "w2": norm(cfg.llm_dim, cfg.llm_dim), "b2": const(cfg.llm_dim, 0.0)}


def space_to_channel(feats: torch.Tensor, side: int, pool: int) -> torch.Tensor:
    """(B, side*side, D) -> (B, (side/pool)^2, D*pool^2): each pool x pool
    block's features concatenate along the channels, row-major within the
    block (VILA ``mlp_downsample``'s flatten order)."""
    b, n, d = feats.shape
    if n != side * side or side % pool:
        raise ValueError(f"{n} features are not a {side}x{side} grid divisible by {pool}")
    ps = side // pool
    grid = feats.reshape(b, ps, pool, ps, pool, d).permute(0, 1, 3, 2, 4, 5)  # (B, ps, ps, pool, pool, D)
    return grid.reshape(b, ps * ps, pool * pool * d)


def project(proj: dict, feats: torch.Tensor, cfg: NvilaProjectorConfig, side: int) -> torch.Tensor:
    """Tower features (B, side*side, vision_dim) -> (B * (side/pool)^2,
    llm_dim). Mixed dtypes promote as in JAX: bf16 tower features meet an
    fp32 connector in fp32."""
    z = _layernorm(space_to_channel(feats, side, cfg.pool), proj["ln_w"], proj["ln_b"], 1e-5)
    dt = torch.promote_types(z.dtype, proj["w1"].dtype)
    z = torch.nn.functional.gelu(z.to(dt) @ proj["w1"].to(dt) + proj["b1"].to(dt), approximate="none")
    z = z @ proj["w2"].to(dt) + proj["b2"].to(dt)
    return z.reshape(-1, cfg.llm_dim)


def encode_video(vit_params: dict, vit_cfg: siglip.ViTConfig, proj: dict, cfg: NvilaProjectorConfig, frames,
                 frame_batch: int = 16, attn_impl: str = "flash") -> torch.Tensor:
    """(n_frames, H, W, 3) pixels -> (n_frames * patch_num, llm_dim) tokens
    on the tower's device, ``patch_num = (patches_per_side / pool)^2`` (the
    geometry the adapter's ``patch_num = tokens / frames`` expects); frames
    go to the device ``frame_batch`` at a time."""
    frames = torch.as_tensor(frames)
    outs = []
    for i in range(0, frames.shape[0], frame_batch):
        with span("vision.tower"):
            feats = siglip.encode(vit_params, frames[i:i + frame_batch], vit_cfg, feature_layer=-2,
                                  attn_impl=attn_impl)
        with span("vision.project"):
            outs.append(project(proj, feats, cfg, vit_cfg.patches_per_side))
    return outs[0] if len(outs) == 1 else torch.cat(outs)
