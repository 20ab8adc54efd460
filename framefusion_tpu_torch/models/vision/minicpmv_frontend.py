"""MiniCPM-V 2.6 vision frontend: SigLIP features -> 64 resampled tokens a
frame (port of ``framefusion_tpu.models.vision.minicpmv_frontend``).

The perceiver resampler of MiniCPM-V 2.6: ``num_queries`` learned queries
in the LLM width; keys and values are ``kv_proj`` of the tower's last
hidden state (no bias) after a LayerNorm, the keys carrying a fixed 2D
sin-cos position embedding of the frame's patch grid; one multi-head
cross-attention, then LayerNorm and the raw ``proj`` matrix.

The cross-attention is a plain einsum and softmax in fp32, as JAX computes
it: its 64 queries attend to N keys, a shape the square kernel E does not
take. The tower's own attention is kernel E (``attn_impl="flash"``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...runtime.profiling import span
from . import siglip
from .siglip import _layernorm
from ..qwen2 import params_from_numpy  # noqa: F401  (JAX's resampler tree carries over alike)
from ...weights import resolve_device, to_numpy


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    num_queries: int = 64
    embed_dim: int = 3584  # LLM hidden
    num_heads: int = 28
    kv_dim: int = 1152  # SigLIP width
    max_size: int = 70  # max patches a side for the position table
    dtype: torch.dtype = torch.float32


def tiny_resampler_config(**kw) -> ResamplerConfig:
    base = dict(num_queries=8, embed_dim=64, num_heads=4, kv_dim=64, max_size=16)
    base.update(kw)
    return ResamplerConfig(**base)


def sincos_pos_embed_2d(h: int, w: int, dim: int) -> np.ndarray:
    """(h*w, dim) float32 2D sin-cos position embedding, computed in float64
    numpy as the JAX package does: the first half of the channels encodes
    the row, the second half the column."""
    if dim % 4:
        raise ValueError(f"dim {dim} is not a multiple of 4")
    quarter = dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def axis(pos):
        out = pos[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)  # (n, dim/2)

    gh = np.repeat(np.arange(h, dtype=np.float64), w)
    gw = np.tile(np.arange(w, dtype=np.float64), h)
    return np.concatenate([axis(gh), axis(gw)], axis=1).astype(np.float32)


def init_params(cfg: ResamplerConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal resampler (scale 0.02; LayerNorms at 1 / 0, biases 0)
    drawn from ``generator`` in ``cfg.dtype`` on ``device`` (the
    generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device
    d = cfg.embed_dim

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(0.02)

    def ones():
        return torch.ones((d,), device=device, dtype=cfg.dtype)

    def zeros():
        return torch.zeros((d,), device=device, dtype=cfg.dtype)

    query, w_kv = norm(cfg.num_queries, d), norm(cfg.kv_dim, d)
    w_q, w_k, w_v, w_o, proj = (norm(d, d) for _ in range(5))
    return {"query": query, "w_kv": w_kv, "ln_q_w": ones(), "ln_q_b": zeros(), "ln_kv_w": ones(),
            "ln_kv_b": zeros(), "w_q": w_q, "b_q": zeros(), "w_k": w_k, "b_k": zeros(), "w_v": w_v,
            "b_v": zeros(), "w_o": w_o, "b_o": zeros(), "ln_post_w": ones(), "ln_post_b": zeros(), "proj": proj}


def params_from_remote(state_dict, cfg: ResamplerConfig, prefix: str = "resampler.", device=None) -> dict:
    """The hub checkpoint's ``Resampler`` (MiniCPM-V's remote code): the fused
    ``attn.in_proj_*`` (torch MultiheadAttention's q | k | v rows) split in
    three, ``kv_proj`` with no bias, ``ln_q`` / ``ln_kv`` / ``ln_post``, the
    raw ``proj`` matrix (applied as ``x @ proj``) and the learned ``query``;
    in ``cfg.dtype`` on ``device`` (``weights.resolve_device``'s rule)."""
    device = resolve_device(device)
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    d = cfg.embed_dim

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    def get(name):
        return to_numpy(sd[name])

    in_w, in_b = get("attn.in_proj_weight"), get("attn.in_proj_bias")  # (3D, D), (3D,)
    return {
        "query": tensor(get("query")), "w_kv": tensor(get("kv_proj.weight").T),
        "ln_q_w": tensor(get("ln_q.weight")), "ln_q_b": tensor(get("ln_q.bias")),
        "ln_kv_w": tensor(get("ln_kv.weight")), "ln_kv_b": tensor(get("ln_kv.bias")),
        "w_q": tensor(in_w[:d].T), "b_q": tensor(in_b[:d]),
        "w_k": tensor(in_w[d:2 * d].T), "b_k": tensor(in_b[d:2 * d]),
        "w_v": tensor(in_w[2 * d:].T), "b_v": tensor(in_b[2 * d:]),
        "w_o": tensor(get("attn.out_proj.weight").T), "b_o": tensor(get("attn.out_proj.bias")),
        "ln_post_w": tensor(get("ln_post.weight")), "ln_post_b": tensor(get("ln_post.bias")),
        "proj": tensor(get("proj")),
    }


def resample(params: dict, features: torch.Tensor, grid_h: int, grid_w: int, cfg: ResamplerConfig) -> torch.Tensor:
    """(B, h*w, kv_dim) tower features -> (B, num_queries, embed_dim). Mixed
    dtypes promote as in JAX: bf16 tower features meet an fp32 resampler in
    fp32; the scores and the probability-weighted sum accumulate in fp32."""
    dt = torch.promote_types(features.dtype, params["w_kv"].dtype)
    p = {k: v.to(dt) for k, v in params.items()}
    b = features.shape[0]
    d, nh = cfg.embed_dim, cfg.num_heads
    hd = d // nh

    kv = _layernorm(features.to(dt) @ p["w_kv"], p["ln_kv_w"], p["ln_kv_b"], 1e-5)  # (B, N, D)
    pos = torch.from_numpy(sincos_pos_embed_2d(grid_h, grid_w, d)).to(device=kv.device)  # (N, D) fp32
    q = _layernorm(p["query"], p["ln_q_w"], p["ln_q_b"], 1e-5)  # (Q, D)

    qh = (q @ p["w_q"] + p["b_q"]).reshape(cfg.num_queries, nh, hd)
    kh = ((kv + pos[None]).to(dt) @ p["w_k"] + p["b_k"]).reshape(b, -1, nh, hd)
    vh = (kv @ p["w_v"] + p["b_v"]).reshape(b, -1, nh, hd)
    scores = torch.einsum("qhd,bkhd->bhqk", qh.to(torch.float32), kh.to(torch.float32))
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype).to(torch.float32), vh.to(torch.float32))
    out = out.reshape(b, cfg.num_queries, d).to(dt) @ p["w_o"] + p["b_o"]
    return _layernorm(out, p["ln_post_w"], p["ln_post_b"], 1e-5) @ p["proj"]


def encode_video(vit_params: dict, vit_cfg: siglip.ViTConfig, res_params: dict, res_cfg: ResamplerConfig, frames,
                 frame_batch: int = 16, attn_impl: str = "flash") -> torch.Tensor:
    """(n_frames, H, W, 3) pixels -> (n_frames, num_queries, embed_dim) on
    the tower's device: the SigLIP tower's last hidden state (post
    LayerNorm, ``feature_layer=-1``), then the resampler, ``frame_batch``
    frames at a time."""
    frames = torch.as_tensor(frames)
    side = vit_cfg.patches_per_side
    outs = []
    for i in range(0, frames.shape[0], frame_batch):
        with span("vision.tower"):
            feats = siglip.encode(vit_params, frames[i:i + frame_batch], vit_cfg, feature_layer=-1,
                                  attn_impl=attn_impl)
        with span("vision.project"):
            outs.append(resample(res_params, feats, side, side, res_cfg))
    return outs[0] if len(outs) == 1 else torch.cat(outs)
