"""InternViT vision tower and pixel-shuffle projector, the InternVL family's
(port of ``framefusion_tpu.models.vision.internvl_vit``).

Architecture (HF ``InternVLVisionModel``, the remote-code ``InternVisionModel``
of the InternVL2.5 hub checkpoints):

  * Conv2D patch embedding (+ bias) as unfold + matmul (stride equals the
    kernel), a CLS token, learned position embeddings over CLS + patches;
  * pre-LN blocks with layer-scale residuals: x + lambda_1 * attn(ln1(x)),
    then x + lambda_2 * mlp(ln2(x)); full (non-causal) MHA with separate
    q / k / v projections (bias and qk norm per config; the qk norm is an
    RMSNorm over the full embed dim, before the head split);
  * the final layernorm is identity (``use_mean_pooling`` checkpoints);
  * features: drop CLS, reshape to the (side, side) grid, pixel-shuffle by
    ``downsample_ratio`` (2x2 patches -> 4x channels), then the ``mlp1``
    projector LayerNorm -> Linear -> GELU -> Linear into the LLM width.

The attention is kernel E (ops/kernels/bidir_attention.py) with B = frames,
N = patches + 1 and the tower's head dim (64 for InternViT-300M) under
``attn_impl="flash"``; its wrapper runs the plain version for CPU tensors.
``"einsum"`` is the JAX tower's reference path (fp32 scores, probabilities
cast to V's dtype).

Parameters live in ``cfg.dtype``: ``weights.load_checkpoint`` loads the
tower and the projector in the requested dtype (bf16 by default, which
kernel E takes), where the JAX loader keeps them fp32; hub checkpoints store
them in bf16, so the values are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.kernels.bidir_attention import flash_bidir_attention
from ...runtime.profiling import span
from ...weights import resolve_device, to_numpy
from ..qwen2 import layer_slice
from .siglip import _layernorm

ATTN_IMPLS = ("einsum", "flash")


@dataclasses.dataclass(frozen=True)
class InternViTConfig:
    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    attention_bias: bool = False
    use_qk_norm: bool = False
    text_hidden_size: int = 4096  # the projector's output (the LLM's width)
    downsample_ratio: float = 0.5
    dtype: torch.dtype = torch.float32

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def shuffle_unit(self) -> int:
        return int(1 / self.downsample_ratio) ** 2

    @property
    def tokens_per_image(self) -> int:
        side = int(self.patches_per_side * self.downsample_ratio)
        return side * side


def tiny_internvit_config(**kw) -> InternViTConfig:
    base = dict(image_size=28, patch_size=7, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                text_hidden_size=32)
    base.update(kw)
    return InternViTConfig(**base)


def internvit_300m_config(**kw) -> InternViTConfig:
    """InternViT-300M-448px-V2.5, InternVL2.5-8B's tower: image 448, patch
    14, hidden 1024, 24 layers, 16 heads of 64, intermediate 4096, qkv bias,
    no qk norm, pixel shuffle 0.5 into the 4096-wide InternLM2.5-7B."""
    base = dict(attention_bias=True, text_hidden_size=4096)
    base.update(kw)
    return InternViTConfig(**base)


def init_params(cfg: InternViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal weights (scale 0.02) drawn from ``generator`` in
    ``cfg.dtype`` on ``device`` (the generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device

    def norm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(scale)

    def full(value, *shape):
        return torch.full(shape, value, device=device, dtype=cfg.dtype)

    d, i, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    layers = {
        "ln1_w": full(1.0, n_l, d), "ln1_b": full(0.0, n_l, d), "ln2_w": full(1.0, n_l, d), "ln2_b": full(0.0, n_l, d),
        "wq": norm(n_l, d, d), "wk": norm(n_l, d, d), "wv": norm(n_l, d, d), "wo": norm(n_l, d, d),
        "bo": full(0.0, n_l, d), "w_fc1": norm(n_l, d, i), "b_fc1": full(0.0, n_l, i), "w_fc2": norm(n_l, i, d),
        "b_fc2": full(0.0, n_l, d), "lambda1": full(0.1, n_l, d), "lambda2": full(0.1, n_l, d),
    }
    if cfg.attention_bias:
        layers.update(bq=full(0.0, n_l, d), bk=full(0.0, n_l, d), bv=full(0.0, n_l, d))
    if cfg.use_qk_norm:
        layers.update(qnorm_w=full(1.0, n_l, d), knorm_w=full(1.0, n_l, d))
    return {
        "patch_kernel": norm(cfg.patch_size, cfg.patch_size, 3, d),
        "patch_bias": full(0.0, d),
        "cls_token": full(0.0, d),
        "pos_embed": norm(cfg.num_patches + 1, d),
        "layers": layers,
    }


def init_projector(cfg: InternViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random ``mlp1`` projector (scale 0.02) in ``cfg.dtype``."""
    device = torch.device(device) if device is not None else generator.device
    din, t = cfg.hidden_size * cfg.shuffle_unit, cfg.text_hidden_size

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(0.02)

    return {
        "ln_w": torch.ones((din,), device=device, dtype=cfg.dtype),
        "ln_b": torch.zeros((din,), device=device, dtype=cfg.dtype),
        "w1": norm(din, t), "b1": torch.zeros((t,), device=device, dtype=cfg.dtype),
        "w2": norm(t, t), "b2": torch.zeros((t,), device=device, dtype=cfg.dtype),
    }


def _importer(state_dict, prefix: str, cfg: InternViTConfig, device):
    """(the prefix-stripped state, tensor(a), stack(fmt, transpose))."""
    device = resolve_device(device)
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    def stack(fmt, transpose=False):
        arrs = [to_numpy(sd[fmt.format(i)]) for i in range(cfg.num_layers)]
        return tensor(np.stack([a.T if transpose else a for a in arrs]))

    return sd, tensor, stack


def params_from_hf(state_dict, cfg: InternViTConfig, prefix: str = "vision_tower.", device=None) -> dict:
    """HF-format ``InternVLVisionModel`` weights (tower only) in ``cfg.dtype``.
    ``device``: the card when None (which raises without one); ``"cpu"``
    for the CPU."""
    sd, tensor, stack = _importer(state_dict, prefix, cfg, device)
    pre = "encoder.layer.{}."
    layers = {
        "ln1_w": stack(pre + "layernorm_before.weight"), "ln1_b": stack(pre + "layernorm_before.bias"),
        "ln2_w": stack(pre + "layernorm_after.weight"), "ln2_b": stack(pre + "layernorm_after.bias"),
        "wq": stack(pre + "attention.q_proj.weight", True), "wk": stack(pre + "attention.k_proj.weight", True),
        "wv": stack(pre + "attention.v_proj.weight", True),
        "wo": stack(pre + "attention.projection_layer.weight", True),
        "bo": stack(pre + "attention.projection_layer.bias"),
        "w_fc1": stack(pre + "mlp.fc1.weight", True), "b_fc1": stack(pre + "mlp.fc1.bias"),
        "w_fc2": stack(pre + "mlp.fc2.weight", True), "b_fc2": stack(pre + "mlp.fc2.bias"),
        "lambda1": stack(pre + "lambda_1"), "lambda2": stack(pre + "lambda_2"),
    }
    if cfg.attention_bias:
        layers.update(bq=stack(pre + "attention.q_proj.bias"), bk=stack(pre + "attention.k_proj.bias"),
                      bv=stack(pre + "attention.v_proj.bias"))
    if cfg.use_qk_norm:
        layers.update(qnorm_w=stack(pre + "attention.q_norm.weight"), knorm_w=stack(pre + "attention.k_norm.weight"))
    # HF conv kernel (D, 3, k, k) -> (k, k, 3, D), the JAX HWIO layout
    kernel = to_numpy(sd["embeddings.patch_embeddings.projection.weight"]).transpose(2, 3, 1, 0)
    return {
        "patch_kernel": tensor(kernel),
        "patch_bias": tensor(to_numpy(sd["embeddings.patch_embeddings.projection.bias"])),
        "cls_token": tensor(to_numpy(sd["embeddings.cls_token"]).reshape(-1)),
        "pos_embed": tensor(to_numpy(sd["embeddings.position_embeddings"])[0]),
        "layers": layers,
    }


def params_from_remote(state_dict, cfg: InternViTConfig, prefix: str = "vision_model.", device=None) -> dict:
    """The hub checkpoints' layout (remote-code ``InternVisionModel``, what
    InternVL2_5-* ship): a fused ``attn.qkv`` (rows q, then k, then v),
    ``ls1`` / ``ls2`` layer scales, ``embeddings.position_embedding``."""
    sd, tensor, stack = _importer(state_dict, prefix, cfg, device)
    d = cfg.hidden_size
    fused = np.stack([to_numpy(sd[f"encoder.layers.{i}.attn.qkv.weight"]) for i in range(cfg.num_layers)])
    pre = "encoder.layers.{}."
    layers = {
        "ln1_w": stack(pre + "norm1.weight"), "ln1_b": stack(pre + "norm1.bias"),
        "ln2_w": stack(pre + "norm2.weight"), "ln2_b": stack(pre + "norm2.bias"),
        "wq": tensor(fused[:, :d].transpose(0, 2, 1)), "wk": tensor(fused[:, d:2 * d].transpose(0, 2, 1)),
        "wv": tensor(fused[:, 2 * d:].transpose(0, 2, 1)),
        "wo": stack(pre + "attn.proj.weight", True), "bo": stack(pre + "attn.proj.bias"),
        "w_fc1": stack(pre + "mlp.fc1.weight", True), "b_fc1": stack(pre + "mlp.fc1.bias"),
        "w_fc2": stack(pre + "mlp.fc2.weight", True), "b_fc2": stack(pre + "mlp.fc2.bias"),
        "lambda1": stack(pre + "ls1"), "lambda2": stack(pre + "ls2"),
    }
    if cfg.attention_bias:
        fb = np.stack([to_numpy(sd[f"encoder.layers.{i}.attn.qkv.bias"]) for i in range(cfg.num_layers)])
        layers.update(bq=tensor(fb[:, :d]), bk=tensor(fb[:, d:2 * d]), bv=tensor(fb[:, 2 * d:]))
    if cfg.use_qk_norm:
        layers.update(qnorm_w=stack(pre + "attn.q_norm.weight"), knorm_w=stack(pre + "attn.k_norm.weight"))
    kernel = to_numpy(sd["embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)
    return {
        "patch_kernel": tensor(kernel),
        "patch_bias": tensor(to_numpy(sd["embeddings.patch_embedding.bias"])),
        "cls_token": tensor(to_numpy(sd["embeddings.class_embedding"]).reshape(-1)),
        "pos_embed": tensor(to_numpy(sd["embeddings.position_embedding"])[0]),
        "layers": layers,
    }


def _projector(state_dict, cfg: InternViTConfig, prefix: str, names: tuple, device) -> dict:
    sd, tensor, _ = _importer(state_dict, prefix, cfg, device)
    ln, lin1, lin2 = names
    return {
        "ln_w": tensor(to_numpy(sd[f"{ln}.weight"])), "ln_b": tensor(to_numpy(sd[f"{ln}.bias"])),
        "w1": tensor(to_numpy(sd[f"{lin1}.weight"]).T), "b1": tensor(to_numpy(sd[f"{lin1}.bias"])),
        "w2": tensor(to_numpy(sd[f"{lin2}.weight"]).T), "b2": tensor(to_numpy(sd[f"{lin2}.bias"])),
    }


def projector_from_remote(state_dict, cfg: InternViTConfig, prefix: str = "mlp1.", device=None) -> dict:
    """The hub layout's projector: ``mlp1`` = Sequential(LayerNorm, Linear,
    GELU, Linear), applied after the pixel shuffle."""
    return _projector(state_dict, cfg, prefix, ("0", "1", "3"), device)


def projector_from_hf(state_dict, cfg: InternViTConfig, prefix: str = "multi_modal_projector.", device=None) -> dict:
    """HF ``InternVLModel``'s ``multi_modal_projector``."""
    return _projector(state_dict, cfg, prefix, ("layer_norm", "linear_1", "linear_2"), device)


def _rmsnorm(x, w, eps=1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def encode(params: dict, pixels, cfg: InternViTConfig, attn_impl: str = "flash") -> torch.Tensor:
    """Encode images to the last hidden states (CLS + patches).

    Args:
        pixels: (B, H, W, 3) normalized pixels, a tensor or numpy array;
            moved to the params' device and ``cfg.dtype``.
        attn_impl: "flash" (kernel E: B images, N = patches + 1, the
            tower's head dim; its plain version on the CPU) or "einsum" (the
            JAX tower's reference path).
    Returns:
        (B, num_patches + 1, hidden_size).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl: {attn_impl} (one of {ATTN_IMPLS})")
    # Patch embedding as unfold + matmul: the stride-ps VALID convolution
    # (same coverage of the first side*ps pixels, same HWIO flatten order).
    ps, side, d = cfg.patch_size, cfg.patches_per_side, cfg.hidden_size
    dev = params["patch_kernel"].device
    pixels = torch.as_tensor(pixels)
    b = pixels.shape[0]
    crop = pixels[:, : side * ps, : side * ps, :].to(device=dev, dtype=cfg.dtype)
    px = crop.reshape(b, side, ps, side, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.num_patches, ps * ps * 3)
    x = px @ params["patch_kernel"].reshape(ps * ps * 3, d) + params["patch_bias"]
    x = torch.cat([params["cls_token"].expand(b, 1, d), x], dim=1) + params["pos_embed"][None]

    nh, hd, n = cfg.num_heads, cfg.head_dim, x.shape[1]
    scale = 1.0 / hd ** 0.5
    for l in range(cfg.num_layers):
        lp = layer_slice(params["layers"], l)
        z = _layernorm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q, k, v = z @ lp["wq"], z @ lp["wk"], z @ lp["wv"]
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.use_qk_norm:
            # HF normalizes over the FULL embed dim before the head split.
            q, k = _rmsnorm(q, lp["qnorm_w"]), _rmsnorm(k, lp["knorm_w"])
        q, k, v = (t.reshape(b, n, nh, hd) for t in (q, k, v))
        if attn_impl == "flash":
            out = flash_bidir_attention(q, k, v, scale=scale)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
        x = x + lp["lambda1"] * (out.reshape(b, n, d).to(x.dtype) @ lp["wo"] + lp["bo"])
        z = _layernorm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        z = torch.nn.functional.gelu(z @ lp["w_fc1"] + lp["b_fc1"])  # exact (erf) GELU
        x = x + lp["lambda2"] * (z @ lp["w_fc2"] + lp["b_fc2"])
    return x  # the final layernorm is identity (use_mean_pooling checkpoints)


def pixel_shuffle(x: torch.Tensor, scale_factor: float = 0.5) -> torch.Tensor:
    """HF ``InternVLModel.pixel_shuffle``: (B, W, H, C) -> (B, W*sf, H*sf,
    C/sf^2) through the same view / permute sequence."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * scale_factor), int(c / scale_factor)).permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * scale_factor), int(w * scale_factor), int(c / (scale_factor ** 2)))
    return x.permute(0, 2, 1, 3)


def extract_features(vit_params: dict, proj_params: dict, pixels, cfg: InternViTConfig,
                     attn_impl: str = "flash") -> torch.Tensor:
    """Pixels -> per-image LLM embedding rows (the reference's
    ``extract_feature``, HF ``InternVLModel.get_image_features``): encode,
    drop CLS, reshape to the patch grid, pixel-shuffle by
    ``downsample_ratio``, project.

    Returns: (B, tokens_per_image, text_hidden_size).
    """
    with span("vision.tower"):
        feats = encode(vit_params, pixels, cfg, attn_impl)[:, 1:, :]  # drop CLS
    with span("vision.project"):
        b, side = feats.shape[0], cfg.patches_per_side
        feats = pixel_shuffle(feats.reshape(b, side, side, cfg.hidden_size), cfg.downsample_ratio)
        feats = feats.reshape(b, -1, feats.shape[-1])
        z = _layernorm(feats, proj_params["ln_w"], proj_params["ln_b"], 1e-5)
        z = torch.nn.functional.gelu(z @ proj_params["w1"] + proj_params["b1"])
        return z @ proj_params["w2"] + proj_params["b2"]
