"""Qwen2-VL vision transformer, the ``visual`` tower (port of
``framefusion_tpu.models.vision.qwen2_vl_vit``).

Architecture (HF ``Qwen2VisionTransformerPretrainedModel``):

  * patch embedding: a Conv3D (temporal_patch x patch x patch, no bias)
    whose stride equals its kernel, so one matmul over the flattened pixel
    patches;
  * a 2D rotary embedding over the (h, w) patch coordinates, head_dim/4
    frequencies per axis, on q and k;
  * ``depth`` pre-LN blocks: LayerNorm -> full (non-causal) attention within
    each temporal frame -> LayerNorm -> MLP (quick_gelu);
  * the PatchMerger: LayerNorm, then each 2x2 spatial block (contiguous rows:
    the patches come in merge-block order) through Linear(4D -> 4D) -> exact
    GELU -> Linear(4D -> llm_hidden).

The per-frame attention is kernel E (ops/kernels/bidir_attention.py) with
B = grid_t, N = grid_h * grid_w and the tower's head dim (80 for
Qwen2-VL-7B) under ``attn_impl="flash"``; its wrapper runs the plain
version for CPU tensors. ``"einsum"`` is the JAX tower's reference path
(fp32 scores, probabilities cast to V's dtype).

The tower's parameters live in ``cfg.dtype``: ``weights.load_checkpoint``
loads it in the requested dtype (bf16 by default, which kernel E takes),
as it loads SigLIP; the JAX loader keeps it fp32. Hub checkpoints store it
in bf16, so the values are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.kernels.bidir_attention import flash_bidir_attention
from ...weights import resolve_device, to_numpy
from ..qwen2 import layer_slice
from .siglip import _layernorm

ATTN_IMPLS = ("einsum", "flash")


@dataclasses.dataclass(frozen=True)
class Qwen2VLViTConfig:
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    in_channels: int = 3
    spatial_merge_size: int = 2
    mlp_ratio: float = 4.0
    hidden_size: int = 3584  # the LLM's width (the merger's output)
    layer_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


def tiny_qwen2vl_vit_config(**kw) -> Qwen2VLViTConfig:
    base = dict(embed_dim=64, depth=2, num_heads=4, patch_size=7, temporal_patch_size=2, mlp_ratio=2.0,
                hidden_size=32)
    base.update(kw)
    return Qwen2VLViTConfig(**base)


def init_params(cfg: Qwen2VLViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal weights (scale 0.02) drawn from ``generator`` in
    ``cfg.dtype`` on ``device`` (the generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device

    def norm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    d, i, n_l, mu = cfg.embed_dim, cfg.mlp_hidden, cfg.depth, cfg.merge_unit
    layers = {
        "ln1_w": ones(n_l, d), "ln1_b": zeros(n_l, d), "ln2_w": ones(n_l, d), "ln2_b": zeros(n_l, d),
        "w_qkv": norm(n_l, d, 3 * d), "b_qkv": zeros(n_l, 3 * d), "wo": norm(n_l, d, d), "bo": zeros(n_l, d),
        "w_fc1": norm(n_l, d, i), "b_fc1": zeros(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": zeros(n_l, d),
    }
    return {
        "patch_proj": norm(cfg.patch_dim, d),
        "layers": layers,
        "merger_ln_w": ones(d), "merger_ln_b": zeros(d),
        "merger_w0": norm(mu * d, mu * d), "merger_b0": zeros(mu * d),
        "merger_w1": norm(mu * d, cfg.hidden_size), "merger_b1": zeros(cfg.hidden_size),
    }


def params_from_hf(state_dict, cfg: Qwen2VLViTConfig, prefix: str = "visual.", device=None) -> dict:
    """HF ``Qwen2VisionTransformerPretrainedModel`` weights in ``cfg.dtype``.

    ``state_dict``: name -> numpy array or tensor; ``prefix`` is the tower's
    path in the checkpoint (``"visual."`` in a Qwen2-VL hub checkpoint).
    ``device``: the card when None (which raises without one); ``"cpu"``
    for the CPU."""
    device = resolve_device(device)
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    def stack(fmt, transpose=False):
        arrs = [to_numpy(sd[fmt.format(i)]) for i in range(cfg.depth)]
        return tensor(np.stack([a.T if transpose else a for a in arrs]))

    pre = "blocks.{}."
    layers = {
        "ln1_w": stack(pre + "norm1.weight"), "ln1_b": stack(pre + "norm1.bias"),
        "ln2_w": stack(pre + "norm2.weight"), "ln2_b": stack(pre + "norm2.bias"),
        "w_qkv": stack(pre + "attn.qkv.weight", True), "b_qkv": stack(pre + "attn.qkv.bias"),
        "wo": stack(pre + "attn.proj.weight", True), "bo": stack(pre + "attn.proj.bias"),
        "w_fc1": stack(pre + "mlp.fc1.weight", True), "b_fc1": stack(pre + "mlp.fc1.bias"),
        "w_fc2": stack(pre + "mlp.fc2.weight", True), "b_fc2": stack(pre + "mlp.fc2.bias"),
    }
    # The Conv3d kernel (D, C, tp, p, p) as the (C*tp*p*p -> D) matmul over
    # the processor's flattened patch rows (stride == kernel).
    kernel = to_numpy(sd["patch_embed.proj.weight"]).reshape(cfg.embed_dim, cfg.patch_dim).T
    return {
        "patch_proj": tensor(kernel),
        "layers": layers,
        "merger_ln_w": tensor(to_numpy(sd["merger.ln_q.weight"])),
        "merger_ln_b": tensor(to_numpy(sd["merger.ln_q.bias"])),
        "merger_w0": tensor(to_numpy(sd["merger.mlp.0.weight"]).T),
        "merger_b0": tensor(to_numpy(sd["merger.mlp.0.bias"])),
        "merger_w1": tensor(to_numpy(sd["merger.mlp.2.weight"]).T),
        "merger_b1": tensor(to_numpy(sd["merger.mlp.2.bias"])),
    }


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def vision_rope_cos_sin(grid_h: int, grid_w: int, cfg: Qwen2VLViTConfig, device=None):
    """(h*w, head_dim) fp32 cos/sin for one frame, in the processor's
    merge-block patch order (HF ``rot_pos_emb``: block-major (hb, wb), then
    (mh, mw) inside each merge block): head_dim/4 frequencies per axis,
    h-frequencies then w-frequencies, duplicated to both halves. Computed in
    float64 on the host, as the JAX tower does, then cast."""
    m = cfg.spatial_merge_size
    dim = cfg.head_dim // 2  # HF VisionRotaryEmbedding's dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    hb, wb = grid_h // m, grid_w // m
    hpos = np.arange(grid_h).reshape(hb, m, 1, 1) + np.zeros((1, 1, wb, m), np.int64)
    wpos = np.arange(grid_w).reshape(1, 1, wb, m) + np.zeros((hb, m, 1, 1), np.int64)
    hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)  # block order (hb, wb, mh, mw)
    wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
    freqs = np.concatenate([hpos[:, None] * inv_freq[None, :], wpos[:, None] * inv_freq[None, :]], axis=-1)
    emb = np.concatenate([freqs, freqs], axis=-1)

    def table(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return table(np.cos(emb)), table(np.sin(emb))


def _apply_vision_rope(x, cos, sin):
    """x: (t, hw, H, hd); cos/sin: (hw, hd). Math in fp32."""
    xf = x.to(torch.float32)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)


def encode_video(params: dict, patches, grid_t: int, grid_h: int, grid_w: int, cfg: Qwen2VLViTConfig,
                 attn_impl: str = "flash") -> torch.Tensor:
    """Encode one video's pixel patches to LLM embedding rows.

    Args:
        patches: (grid_t * grid_h * grid_w, C*tp*p*p) flattened pixel
            patches in the HF processor's layout (``pixels_to_patches``), a
            tensor or numpy array; moved to the params' device and
            ``cfg.dtype``.
        attn_impl: "flash" (kernel E per frame: B = grid_t, N = grid_h *
            grid_w; its plain version on the CPU) or "einsum" (the JAX
            tower's reference path).
    Returns:
        (grid_t * grid_h * grid_w / merge^2, hidden_size): one row per
        merged 2x2 block, the layout spliced into the prompt.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl: {attn_impl} (one of {ATTN_IMPLS})")
    n, hw = grid_t * grid_h * grid_w, grid_h * grid_w
    nh, hd = cfg.num_heads, cfg.head_dim
    if tuple(patches.shape) != (n, cfg.patch_dim):
        raise ValueError(f"patches {tuple(patches.shape)} do not match the grid ({grid_t}, {grid_h}, {grid_w}): "
                         f"want ({n}, {cfg.patch_dim})")
    scale = 1.0 / hd ** 0.5
    dev = params["patch_proj"].device
    x = torch.as_tensor(patches).to(device=dev, dtype=cfg.dtype) @ params["patch_proj"]  # (N, D)
    cos, sin = vision_rope_cos_sin(grid_h, grid_w, cfg, dev)

    for l in range(cfg.depth):
        lp = layer_slice(params["layers"], l)
        z = _layernorm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        qkv = (z @ lp["w_qkv"] + lp["b_qkv"]).reshape(grid_t, hw, 3, nh, hd)
        q = _apply_vision_rope(qkv[:, :, 0], cos, sin)
        k = _apply_vision_rope(qkv[:, :, 1], cos, sin)
        v = qkv[:, :, 2].contiguous()
        # Full attention within each frame (HF splits the sequence at
        # cu_seqlens, one chunk per temporal frame).
        if attn_impl == "flash":
            out = flash_bidir_attention(q, k, v, scale=scale)
        else:
            scores = torch.einsum("tqhd,tkhd->thqk", q.to(torch.float32), k.to(torch.float32)) * scale
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("thqk,tkhd->tqhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
        x = x + (out.reshape(n, cfg.embed_dim).to(x.dtype) @ lp["wo"] + lp["bo"])
        z = _layernorm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        z = z @ lp["w_fc1"] + lp["b_fc1"]
        z = z * torch.sigmoid(1.702 * z)  # quick_gelu
        x = x + (z @ lp["w_fc2"] + lp["b_fc2"])

    z = _layernorm(x, params["merger_ln_w"], params["merger_ln_b"], cfg.layer_norm_eps)
    z = z.reshape(n // cfg.merge_unit, cfg.merge_unit * cfg.embed_dim)
    z = torch.nn.functional.gelu(z @ params["merger_w0"] + params["merger_b0"])  # exact (erf) GELU
    return z @ params["merger_w1"] + params["merger_b1"]


def pixels_to_patches(frames: np.ndarray, cfg: Qwen2VLViTConfig):
    """Video frames -> (flattened patches, (grid_t, grid_h, grid_w)): the HF
    ``Qwen2VLImageProcessor`` patch layout (temporal pairing, the last frame
    repeated for an odd count; merge-block order), without the resize and
    normalization, which preprocessing does.

    Args:
        frames: (T, H, W, C) float pixels, H and W multiples of
            patch_size * spatial_merge_size.
    """
    t, h, w, c = frames.shape
    p, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    if h % (p * m) or w % (p * m):
        raise ValueError(f"frame size {h}x{w} is not a multiple of patch * merge = {p * m}")
    if t % tp:
        frames = np.concatenate([frames, np.repeat(frames[-1:], tp - t % tp, axis=0)])
        t = frames.shape[0]
    grid_t, grid_h, grid_w = t // tp, h // p, w // p
    x = frames.transpose(0, 3, 1, 2).reshape(grid_t, tp, c, grid_h // m, m, p, grid_w // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(grid_t * grid_h * grid_w, cfg.patch_dim), (grid_t, grid_h, grid_w)
