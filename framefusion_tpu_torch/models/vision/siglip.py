"""SigLIP-style vision transformer, LLaVA-Video's tower (siglip-so400m@384/14).

Port of ``framefusion_tpu.models.vision.siglip``: patch embedding as
unfold + matmul, learned position embeddings (no CLS token), pre-LN encoder
blocks with bidirectional MHA and a GELU-tanh MLP, final layernorm. Plain
functions over a dict of parameters in the JAX package's layout: layer
weights stacked along a leading layer axis, matrices (K, O) applied as
``x @ w``, an int8 weight the pair ``{"q8", "scale"}``.

``attn_impl`` selects the tower's attention: ``"flash"`` goes through
kernel E (ops/kernels/bidir_attention.py), whose wrapper runs its plain
version for CPU tensors; ``"einsum"`` is the JAX tower's reference path
(fp32 scores, probabilities cast to V's dtype).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...ops.kernels.bidir_attention import flash_bidir_attention
from ...weights import resolve_device, to_numpy
from ..qwen2 import layer_slice, mm, params_from_numpy  # noqa: F401  (the tower's pytree carries over alike)

ATTN_IMPLS = ("einsum", "flash")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2


def tiny_vit_config(**kw) -> ViTConfig:
    base = dict(image_size=28, patch_size=7, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4)
    base.update(kw)
    return ViTConfig(**base)


def init_params(cfg: ViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal weights (scale 0.02) drawn from ``generator`` in
    ``cfg.dtype`` on ``device`` (the generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device

    def norm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    d, i, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    layers = {
        "ln1_w": ones(n_l, d), "ln1_b": zeros(n_l, d), "ln2_w": ones(n_l, d), "ln2_b": zeros(n_l, d),
        "wq": norm(n_l, d, d), "bq": zeros(n_l, d), "wk": norm(n_l, d, d), "bk": zeros(n_l, d),
        "wv": norm(n_l, d, d), "bv": zeros(n_l, d), "wo": norm(n_l, d, d), "bo": zeros(n_l, d),
        "w_fc1": norm(n_l, d, i), "b_fc1": zeros(n_l, i), "w_fc2": norm(n_l, i, d), "b_fc2": zeros(n_l, d),
    }
    return {
        "patch_kernel": norm(cfg.patch_size, cfg.patch_size, 3, d),
        "patch_bias": zeros(d),
        "pos_embed": norm(cfg.num_patches, d),
        "layers": layers,
        "post_ln_w": ones(d),
        "post_ln_b": zeros(d),
    }


def params_from_hf(state_dict, cfg: ViTConfig, prefix: str = "vision_model.", device=None) -> dict:
    """HF ``SiglipVisionModel`` weights (also the layout inside LLaVA-Video
    hub checkpoints under ``model.vision_tower.vision_tower.vision_model.``).
    ``device``: the card when None (which raises without one); ``"cpu"``
    for the CPU."""
    device = resolve_device(device)
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    def stack(fmt, transpose=False):
        arrs = [to_numpy(sd[fmt.format(i)]) for i in range(cfg.num_layers)]
        return tensor(np.stack([a.T if transpose else a for a in arrs]))

    pre = "encoder.layers.{}."
    layers = {
        "ln1_w": stack(pre + "layer_norm1.weight"), "ln1_b": stack(pre + "layer_norm1.bias"),
        "ln2_w": stack(pre + "layer_norm2.weight"), "ln2_b": stack(pre + "layer_norm2.bias"),
        "wq": stack(pre + "self_attn.q_proj.weight", True), "bq": stack(pre + "self_attn.q_proj.bias"),
        "wk": stack(pre + "self_attn.k_proj.weight", True), "bk": stack(pre + "self_attn.k_proj.bias"),
        "wv": stack(pre + "self_attn.v_proj.weight", True), "bv": stack(pre + "self_attn.v_proj.bias"),
        "wo": stack(pre + "self_attn.out_proj.weight", True), "bo": stack(pre + "self_attn.out_proj.bias"),
        "w_fc1": stack(pre + "mlp.fc1.weight", True), "b_fc1": stack(pre + "mlp.fc1.bias"),
        "w_fc2": stack(pre + "mlp.fc2.weight", True), "b_fc2": stack(pre + "mlp.fc2.bias"),
    }
    # HF conv kernel: (D, 3, k, k) -> (k, k, 3, D), the JAX HWIO layout
    kernel = to_numpy(sd["embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)
    return {
        "patch_kernel": tensor(kernel),
        "patch_bias": tensor(to_numpy(sd["embeddings.patch_embedding.bias"])),
        "pos_embed": tensor(to_numpy(sd["embeddings.position_embedding.weight"])),
        "layers": layers,
        "post_ln_w": tensor(to_numpy(sd["post_layernorm.weight"])),
        "post_ln_b": tensor(to_numpy(sd["post_layernorm.bias"])),
    }


#: Stacked (L, K, O) encoder matmul weights eligible for int8 quantization.
#: Norms, biases, the patch embedding and the position table keep their dtype.
QUANTIZED_TOWER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_fc1", "w_fc2")


def quantize_tower_int8(params: dict) -> dict:
    """Quantize the encoder matmul stacks to per-output-channel int8 pairs
    (ops/quant.quantize_weight; models/qwen2.mm dispatches on them).
    Consumes ``params``: each stack is replaced in place, so the original
    frees tensor by tensor."""
    from ...ops.quant import quantize_weight

    layers = params["layers"]
    for name in QUANTIZED_TOWER_WEIGHTS:
        w = layers.get(name)
        if w is not None and not isinstance(w, dict):
            layers[name] = quantize_weight(w)
            del w
    return params


def _layernorm(x, w, b, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _mha(lp: dict, x, num_heads: int, attn_impl: str = "flash", w8a8: bool = False):
    """Batched bidirectional MHA: x (B, N, D) -> (B, N, D).

    Weights may be int8 pairs (quantize_tower_int8); ``w8a8=True`` also
    quantizes the activations per row and contracts int8 x int8
    (models/qwen2.mm)."""
    b, n, d = x.shape
    hd = d // num_heads
    q = (mm(x, lp["wq"], w8a8) + lp["bq"]).reshape(b, n, num_heads, hd)
    k = (mm(x, lp["wk"], w8a8) + lp["bk"]).reshape(b, n, num_heads, hd)
    v = (mm(x, lp["wv"], w8a8) + lp["bv"]).reshape(b, n, num_heads, hd)
    if attn_impl == "flash":
        out = flash_bidir_attention(q, k, v)
    elif attn_impl == "einsum":
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
        probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    else:
        raise ValueError(f"unknown attention impl: {attn_impl} (one of {ATTN_IMPLS})")
    return mm(out.reshape(b, n, d).to(x.dtype), lp["wo"], w8a8) + lp["bo"]


def encode(params: dict, pixels, cfg: ViTConfig, feature_layer: int = -1, attn_impl: str = "flash",
           w8a8: bool = False) -> torch.Tensor:
    """Encode images.

    Args:
        pixels: (B, H, W, 3) in [-1, 1], a tensor or numpy array; moved to
            the params' device and ``cfg.dtype``.
        feature_layer: which encoder layer's output to return (-1 = after
            the last block; -2 = penultimate, LLaVA's default vision
            feature). The final ``post_layernorm`` is applied only for -1,
            matching HF hidden_states semantics.
        attn_impl: "flash" (kernel E on the card, its plain version on the
            CPU) or "einsum" (plain reference).
        w8a8: int8 x int8 matmuls (requires quantize_tower_int8 params).

    Returns:
        (B, num_patches, D) features.
    """
    # Patch embedding as unfold + matmul: the stride-ps VALID convolution
    # (same coverage of the first side*ps pixels, same HWIO flatten order).
    ps, side = cfg.patch_size, cfg.patches_per_side
    dev = params["patch_kernel"].device
    pixels = torch.as_tensor(pixels)
    b = pixels.shape[0]
    crop = pixels[:, : side * ps, : side * ps, :].to(device=dev, dtype=cfg.dtype)
    px = crop.reshape(b, side, ps, side, ps, 3).permute(0, 1, 3, 2, 4, 5)
    px = px.reshape(b, cfg.num_patches, ps * ps * 3)
    w = params["patch_kernel"].reshape(ps * ps * 3, cfg.hidden_size)
    x = px @ w + params["patch_bias"]
    x = x + params["pos_embed"][None]

    n_keep = cfg.num_layers + feature_layer + 1 if feature_layer < 0 else feature_layer
    for l in range(n_keep):
        lp = layer_slice(params["layers"], l)
        h = x + _mha(lp, _layernorm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps), cfg.num_heads,
                     attn_impl, w8a8)
        z = _layernorm(h, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        z = torch.nn.functional.gelu(mm(z, lp["w_fc1"], w8a8) + lp["b_fc1"], approximate="tanh")
        x = h + mm(z, lp["w_fc2"], w8a8) + lp["b_fc2"]
    if feature_layer == -1:
        x = _layernorm(x, params["post_ln_w"], params["post_ln_b"], cfg.layer_norm_eps)
    return x
