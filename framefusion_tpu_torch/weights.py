"""Weight import: HuggingFace hub checkpoints -> this package's params
(port of ``framefusion_tpu.weights``, the ``llava_video`` family only).

Linear weights transpose from HF's (out, in) to (in, out), so the forward
is plain ``x @ w``; layer weights stack along a leading layer axis. Entry
points: ``params_from_state_dict`` (any mapping name -> numpy array or
tensor), ``load_state`` (safetensors shards of a checkpoint directory) and
``load_checkpoint`` (config.json + shards -> a ``FrameFusionModel`` with the
SigLIP tower and projector attached).

One difference from the JAX loader: the SigLIP tower is loaded in the
requested ``dtype`` (bf16 by default, which kernel E takes), where the JAX
loader keeps it fp32. A checkpoint stores the tower in bf16, so the values
are the same.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .config import LLMConfig

_QWEN2_LAYER_KEYS = {
    "input_layernorm.weight": ("ln1", False),
    "post_attention_layernorm.weight": ("ln2", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

# Architecture string (config.json ``architectures[0]``) -> family. Only the
# llava_video family is ported; the others are ROADMAP Queue 1 item 11.
_ARCH_TO_FAMILY = {"LlavaQwenForCausalLM": "llava_video"}
_NOT_PORTED = "is not ported to PyTorch yet (ROADMAP Queue 1 item 11: the other families)"


def to_numpy(t) -> np.ndarray:
    """numpy array or tensor (bf16 read as its exact fp32) -> numpy."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _to_tensor(t) -> torch.Tensor:
    return t.detach() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


def _stack_layer_weight(name: str, stacked: torch.Tensor, cfg: LLMConfig, quantize, device):
    """Upload one stacked layer weight; ``quantize="int8"`` quantizes the
    decoder matmul weights on the host first (ops/quant.quantize_weight_host)."""
    from .ops.quant import QUANTIZED_LAYER_WEIGHTS, quantize_weight_host

    if quantize == "int8" and name in QUANTIZED_LAYER_WEIGHTS:
        q = quantize_weight_host(to_numpy(stacked))
        return {"q8": torch.from_numpy(q["q8"]).to(device), "scale": torch.from_numpy(q["scale"]).to(device)}
    return stacked.to(device=device, dtype=cfg.dtype)


def params_from_state_dict(state_dict, cfg: LLMConfig, prefix: str = "model.", quantize=None,
                           device=None) -> dict:
    """The stacked-parameter dict from an HF Qwen2-style state dict.

    Args:
        state_dict: mapping of HF parameter names to numpy arrays or tensors.
        prefix: path of the language model inside the checkpoint
            (``"model."`` for LLaVA-Video).
        quantize: ``"int8"`` quantizes the decoder matmul weights on the
            host during import.
        device: where the params go (the CPU by default).
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize={quantize!r} (None or 'int8')")
    layer_re = re.compile(re.escape(prefix) + r"layers\.(\d+)\.(.+)")
    per_layer: dict[str, dict[int, torch.Tensor]] = {}
    for name, tensor in state_dict.items():
        m = layer_re.match(name)
        if not m or m.group(2) not in _QWEN2_LAYER_KEYS:
            continue
        ours, transpose = _QWEN2_LAYER_KEYS[m.group(2)]
        t = _to_tensor(tensor)
        per_layer.setdefault(ours, {})[int(m.group(1))] = t.T if transpose else t

    layers = {}
    for ours, by_idx in per_layer.items():
        if len(by_idx) != cfg.num_layers:
            raise ValueError(f"{ours}: got {len(by_idx)} layers, want {cfg.num_layers}")
        stacked = torch.stack([by_idx[i] for i in range(cfg.num_layers)])
        layers[ours] = _stack_layer_weight(ours, stacked, cfg, quantize, device)

    def plain(key):
        return _to_tensor(state_dict[key]).to(device=device, dtype=cfg.dtype)

    params = {"embed": plain(prefix + "embed_tokens.weight"), "layers": layers,
              "final_norm": plain(prefix + "norm.weight")}
    if not cfg.tie_word_embeddings:
        # lm_head lives at top level regardless of the LM prefix.
        candidates = [k for k in state_dict if k.endswith("lm_head.weight")]
        if not candidates:
            raise ValueError("untied config but no lm_head in checkpoint")
        params["lm_head"] = _to_tensor(state_dict[candidates[0]]).T.to(device=device, dtype=cfg.dtype)
    return params


def load_state(checkpoint_dir: str) -> dict:
    """Read a (possibly sharded) safetensors checkpoint directory into a
    name -> CPU tensor mapping (HF hub layout: ``model.safetensors.index.json``
    with a weight_map, or loose ``*.safetensors`` shards)."""
    from safetensors import safe_open  # lazy: optional dependency

    index_path = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(checkpoint_dir) if f.endswith(".safetensors"))
    state = {}
    for shard in shards:
        with safe_open(os.path.join(checkpoint_dir, shard), framework="pt") as f:
            for name in f.keys():
                state[name] = f.get_tensor(name)
    return state


def llm_config_from_hf(cfg_dict: dict, dtype=torch.bfloat16):
    """HF ``config.json`` dict -> (family, LLMConfig). LLaVA-Video keeps the
    LLM fields at the top level; other architectures raise."""
    arch = (cfg_dict.get("architectures") or ["?"])[0]
    family = _ARCH_TO_FAMILY.get(arch)
    if family is None:
        raise NotImplementedError(f"Model not supported\nArchitecture: {arch} {_NOT_PORTED}")
    text = cfg_dict
    llm = LLMConfig(
        vocab_size=text["vocab_size"],
        hidden_size=text["hidden_size"],
        intermediate_size=text["intermediate_size"],
        num_layers=text["num_hidden_layers"],
        num_heads=text["num_attention_heads"],
        num_kv_heads=text.get("num_key_value_heads", text["num_attention_heads"]),
        rope_theta=float(text.get("rope_theta", 1e6)),
        rms_norm_eps=float(text.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(text.get("tie_word_embeddings", False)),
        qkv_bias=bool(text.get("bias", True)),
        dtype=dtype,
    )
    return family, llm


def _load_vision(state: dict, cfg_dict: dict, llm_cfg: LLMConfig, device):
    """The SigLIP tower and LLaVA projector of a LLaVA-Video checkpoint, or
    None when it carries no (recognizable) vision weights."""
    from .models.vision import siglip

    if not any("vision_tower" in k for k in state):
        return None
    vis_cfg = cfg_dict.get("vision_config") or {}
    try:
        tower_prefix = next(p for p in ("model.vision_tower.vision_tower.vision_model.", "vision_tower.vision_model.")
                            if any(k.startswith(p) for k in state))
        vit_cfg = siglip.ViTConfig(
            image_size=vis_cfg.get("image_size", 384),
            patch_size=vis_cfg.get("patch_size", 14),
            hidden_size=vis_cfg.get("hidden_size", 1152),
            intermediate_size=vis_cfg.get("intermediate_size", 4304),
            num_layers=vis_cfg.get("num_hidden_layers", 27),
            num_heads=vis_cfg.get("num_attention_heads", 16),
            dtype=llm_cfg.dtype,
        )
        vit = siglip.params_from_hf(state, vit_cfg, prefix=tower_prefix, device=device)
        proj = None
        if "model.mm_projector.0.weight" in state:
            def f32(key, transpose=False):
                t = _to_tensor(state[key])
                return (t.T if transpose else t).to(device=device, dtype=torch.float32)

            newline = (f32("model.image_newline") if "model.image_newline" in state
                       else torch.zeros((llm_cfg.hidden_size,), dtype=torch.float32, device=device))
            proj = {"w1": f32("model.mm_projector.0.weight", True), "b1": f32("model.mm_projector.0.bias"),
                    "w2": f32("model.mm_projector.2.weight", True), "b2": f32("model.mm_projector.2.bias"),
                    "image_newline": newline}
    except (KeyError, StopIteration, ValueError):
        return None  # partial/unrecognized vision weights: LLM-only load
    return {"kind": "siglip", "cfg": vit_cfg, "params": vit, "projector": proj}


def load_checkpoint(checkpoint_dir: str, family=None, dtype=torch.bfloat16, quantize=None, device=None):
    """config.json-driven geometry + family dispatch -> a ``FrameFusionModel``
    (vision tower attached when the checkpoint carries one).

    ``quantize="int8"``: decoder matmul weights are quantized on the host
    during import, so the device never holds the bf16 originals. The vision
    tower, embeddings, norms and lm_head keep ``dtype``; the projector is
    fp32, as in the JAX loader.
    """
    from .interface import FAMILIES, FrameFusionModel

    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    detected, llm_cfg = llm_config_from_hf(cfg_dict, dtype=dtype)
    family = family or detected
    if family != "llava_video":
        raise NotImplementedError(f"family {family} {_NOT_PORTED}")
    spec = FAMILIES[family]
    if llm_cfg.qkv_bias != spec.qkv_bias:
        raise ValueError(f"config qkv_bias={llm_cfg.qkv_bias} vs family {family}")
    state = load_state(checkpoint_dir)
    params = params_from_state_dict(state, llm_cfg, prefix=spec.llm_prefix, quantize=quantize, device=device)
    vision = _load_vision(state, cfg_dict, llm_cfg, device)
    return FrameFusionModel(family=family, cfg=llm_cfg, params=params, vision=vision)
