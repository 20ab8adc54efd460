"""Weight import: HuggingFace hub checkpoints -> this package's params
(port of ``framefusion_tpu.weights``: the ``llava_video``,
``llava_next_video``, ``minicpmv``, ``nvila``, ``qwen2_vl`` and ``internvl``
families, and the Qwen2-MoE backbone).

Linear weights transpose from HF's (out, in) to (in, out), so the forward
is plain ``x @ w``; layer weights stack along a leading layer axis. Entry
points: ``params_from_state_dict`` (any mapping name -> numpy array or
tensor), ``params_from_state_dict_internlm2`` (InternLM2's fused ``wqkv``),
``load_state`` (safetensors shards of a checkpoint directory) and
``load_checkpoint`` (config.json + shards -> a ``FrameFusionModel`` with its
vision tower attached: SigLIP and the LLaVA projector, MiniCPM-V's SigLIP
and resampler, the Qwen2-VL or Qwen2.5-VL tower, or InternViT and the
``mlp1`` projector; an NVILA checkpoint loads its LLM only, as in JAX).

One difference from the JAX loader: the towers (and InternVL's projector)
are loaded in the requested ``dtype`` (bf16 by default, which kernel E
takes), where the JAX loader keeps them fp32. A checkpoint stores a tower in
bf16, so the values are the same.
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

# Qwen2-MoE (Qwen2MoeForCausalLM) per-layer sparse-MLP names; the experts'
# weights (_QWEN2_MOE_EXPERT_RE) stack into (L, E, in, out).
_QWEN2_MOE_LAYER_KEYS = {
    "mlp.gate.weight": ("router", True),
    "mlp.shared_expert.gate_proj.weight": ("sw_gate", True),
    "mlp.shared_expert.up_proj.weight": ("sw_up", True),
    "mlp.shared_expert.down_proj.weight": ("sw_down", True),
    "mlp.shared_expert_gate.weight": ("shared_gate", True),
}
_QWEN2_MOE_EXPERT_RE = re.compile(r"mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight")
_EXPERT_NAME = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}

# Architecture string (config.json ``architectures[0]``) -> family. The MoE
# backbone goes through the llava_video interface defaults, as in JAX.
_ARCH_TO_FAMILY = {"LlavaQwenForCausalLM": "llava_video",
                   "LlavaNextVideoForConditionalGeneration": "llava_next_video", "MiniCPMV": "minicpmv",
                   "LlavaLlamaModel": "nvila", "Qwen2VLForConditionalGeneration": "qwen2_vl",
                   "Qwen2_5_VLForConditionalGeneration": "qwen2_vl", "InternVLChatModel": "internvl",
                   "Qwen2MoeForCausalLM": "llava_video"}


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


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None. Without a CUDA device, None
    raises: the CPU runs only the kernels' plain versions, so it is taken
    only when asked for (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the model loads onto the card by default; pass device="cpu" '
                           "to load it onto the CPU (plain versions of the kernels)")
    return torch.device("cuda")


def params_from_state_dict(state_dict, cfg: LLMConfig, prefix: str = "model.", quantize=None,
                           device=None) -> dict:
    """The stacked-parameter dict from an HF Qwen2-style state dict (a
    Qwen2-MoE one when ``cfg.is_moe``: the router, the shared expert and the
    experts' weights stacked per (layer, expert)).

    Args:
        state_dict: mapping of HF parameter names to numpy arrays or tensors.
        prefix: path of the language model inside the checkpoint
            (``"model."`` for LLaVA-Video).
        quantize: ``"int8"`` quantizes the decoder matmul weights on the
            host during import (the expert stacks a (layer, expert) at a
            time).
        device: where the params go: the card when None (which raises
            without one); ``"cpu"`` for the CPU.
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize={quantize!r} (None or 'int8')")
    device = resolve_device(device)
    layer_re = re.compile(re.escape(prefix) + r"layers\.(\d+)\.(.+)")
    key_table = dict(_QWEN2_LAYER_KEYS)
    if cfg.is_moe:
        key_table.update(_QWEN2_MOE_LAYER_KEYS)
        for k in ("mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight"):
            key_table.pop(k)
    per_layer: dict[str, dict[int, torch.Tensor]] = {}
    per_expert: dict[str, dict[tuple, torch.Tensor]] = {}
    for name, tensor in state_dict.items():
        m = layer_re.match(name)
        if not m:
            continue
        idx, sub = int(m.group(1)), m.group(2)
        em = _QWEN2_MOE_EXPERT_RE.fullmatch(sub) if cfg.is_moe else None
        if em:
            per_expert.setdefault(_EXPERT_NAME[em.group(2)], {})[(idx, int(em.group(1)))] = _to_tensor(tensor).T
            continue
        if sub not in key_table:
            continue
        ours, transpose = key_table[sub]
        t = _to_tensor(tensor)
        per_layer.setdefault(ours, {})[idx] = t.T if transpose else t

    layers = {}
    for ours, by_idx in per_layer.items():
        if len(by_idx) != cfg.num_layers:
            raise ValueError(f"{ours}: got {len(by_idx)} layers, want {cfg.num_layers}")
        stacked = torch.stack([by_idx[i] for i in range(cfg.num_layers)])
        layers[ours] = _stack_layer_weight(ours, stacked, cfg, quantize, device)
    for ours, by_le in per_expert.items():
        if len(by_le) != cfg.num_layers * cfg.num_experts:
            raise ValueError(f"{ours}: got {len(by_le)} expert matrices, want {cfg.num_layers}x{cfg.num_experts}")
        stacked = torch.stack([torch.stack([by_le[(l, e)] for e in range(cfg.num_experts)])
                               for l in range(cfg.num_layers)])
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


def params_from_state_dict_internlm2(state_dict, cfg: LLMConfig, prefix: str = "language_model.model.",
                                     quantize=None, device=None) -> dict:
    """The stacked-parameter dict from an InternLM2 (InternVL2.5 backbone)
    state dict.

    InternLM2 stores the attention as one fused ``wqkv`` whose rows are
    grouped per KV head: [g query heads, 1 key head, 1 value head] with g =
    Hq / Hk (the reference unpacks it with einops,
    models/internvl/modeling_internlm2.py:309-321). The MLP's w1 / w3 / w2
    are gate / up / down, the norms attention_norm / ffn_norm; there is no
    qkv bias. ``quantize`` and ``device`` as in ``params_from_state_dict``.
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize={quantize!r} (None or 'int8')")
    if cfg.qkv_bias:
        raise ValueError("InternLM2 has no qkv bias: pass a config with qkv_bias=False")
    device = resolve_device(device)
    hd, hk, d = cfg.head_dim_, cfg.num_kv_heads, cfg.hidden_size
    g = cfg.num_heads // hk

    def layer(i, name):
        return _to_tensor(state_dict[f"{prefix}layers.{i}.{name}"])

    per_layer: dict[str, list] = {}
    for i in range(cfg.num_layers):
        grouped = layer(i, "attention.wqkv.weight").reshape(hk, g + 2, hd, d)
        per_layer.setdefault("wq", []).append(grouped[:, :g].reshape(hk * g * hd, d).T)
        per_layer.setdefault("wk", []).append(grouped[:, g].reshape(hk * hd, d).T)
        per_layer.setdefault("wv", []).append(grouped[:, g + 1].reshape(hk * hd, d).T)
        for ours, name, transpose in (("ln1", "attention_norm.weight", False), ("ln2", "ffn_norm.weight", False),
                                      ("wo", "attention.wo.weight", True), ("w_gate", "feed_forward.w1.weight", True),
                                      ("w_up", "feed_forward.w3.weight", True),
                                      ("w_down", "feed_forward.w2.weight", True)):
            t = layer(i, name)
            per_layer.setdefault(ours, []).append(t.T if transpose else t)
    layers = {ours: _stack_layer_weight(ours, torch.stack(ts), cfg, quantize, device)
              for ours, ts in per_layer.items()}

    def plain(key):
        return _to_tensor(state_dict[key]).to(device=device, dtype=cfg.dtype)

    params = {"embed": plain(prefix + "tok_embeddings.weight"), "layers": layers,
              "final_norm": plain(prefix + "norm.weight")}
    if not cfg.tie_word_embeddings:
        heads = [k for k in state_dict if k.endswith("output.weight") or k.endswith("lm_head.weight")]
        if not heads:
            raise ValueError("untied config but no output head in checkpoint")
        params["lm_head"] = _to_tensor(state_dict[heads[0]]).T.to(device=device, dtype=cfg.dtype)
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
    """HF ``config.json`` dict -> (family, LLMConfig). The LLM fields live at
    the top level, under ``text_config`` or under ``llm_config``
    (InternVL); Qwen2-VL's mRoPE sections come from
    ``rope_scaling.mrope_section``; InternLM2 has no qkv bias (its config's
    ``bias`` flag, or the family); a Qwen2-MoE config brings its expert
    fields (``num_experts`` and the rest, as JAX's ``moe_kw``). Other
    architectures raise.

    InternLM2.5's config may carry a dynamic NTK ``rope_scaling``: it acts
    only past its 32,768 trained positions and, as in the JAX loader, is not
    implemented; the rotary stays plain, so prompts stay below that length.
    """
    arch = (cfg_dict.get("architectures") or ["?"])[0]
    family = _ARCH_TO_FAMILY.get(arch)
    if family is None:
        raise NotImplementedError(f"Model not supported\nArchitecture: {arch}")
    text = next((cfg_dict[key] for key in ("text_config", "llm_config") if isinstance(cfg_dict.get(key), dict)),
                cfg_dict)
    rope_scaling = text.get("rope_scaling") or {}
    mrope_section = None
    if isinstance(rope_scaling, dict) and rope_scaling.get("mrope_section"):
        mrope_section = tuple(int(x) for x in rope_scaling["mrope_section"])
    text_arch = (text.get("architectures") or [arch])[0]
    qkv_bias = bool(text.get("bias", not (family == "internvl" or "InternLM2" in text_arch)))
    moe_kw = {}
    if text.get("num_experts"):
        moe_kw = dict(num_experts=int(text["num_experts"]),
                      num_experts_per_tok=int(text.get("num_experts_per_tok", 2)),
                      moe_intermediate_size=int(text["moe_intermediate_size"]),
                      shared_expert_intermediate_size=int(text.get("shared_expert_intermediate_size", 0)),
                      norm_topk_prob=bool(text.get("norm_topk_prob", False)))
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
        qkv_bias=qkv_bias,
        mrope_section=mrope_section,
        dtype=dtype,
        **moe_kw,
    )
    return family, llm


def _load_qwen2_vl_vision(state: dict, vis_cfg: dict, llm_cfg: LLMConfig, device):
    """The tower of a ``qwen2_vl`` checkpoint in ``llm_cfg.dtype``, or None
    when it carries none: the Qwen2.5-VL tower when its config has
    ``out_hidden_size`` (window attention, RMSNorm, SwiGLU; JAX's defaults
    for ``tokens_per_second`` and ``fullatt_block_indexes``), else the
    Qwen2-VL tower."""
    from .models.vision import qwen2_vl_vit, qwen25_vl_vit

    if not any(k.startswith("visual.") for k in state):
        return None
    if "out_hidden_size" in vis_cfg:
        kind, module = "qwen25_vl_vit", qwen25_vl_vit
        vit_cfg = qwen25_vl_vit.Qwen25VLViTConfig(
            hidden_size=vis_cfg.get("hidden_size", 1280),
            depth=vis_cfg.get("depth", 32),
            num_heads=vis_cfg.get("num_heads", 16),
            intermediate_size=vis_cfg.get("intermediate_size", 3420),
            patch_size=vis_cfg.get("patch_size", 14),
            temporal_patch_size=vis_cfg.get("temporal_patch_size", 2),
            spatial_merge_size=vis_cfg.get("spatial_merge_size", 2),
            window_size=vis_cfg.get("window_size", 112),
            fullatt_block_indexes=tuple(vis_cfg.get("fullatt_block_indexes", (7, 15, 23, 31))),
            out_hidden_size=vis_cfg.get("out_hidden_size", llm_cfg.hidden_size),
            tokens_per_second=vis_cfg.get("tokens_per_second", 4),
            dtype=llm_cfg.dtype,
        )
    else:
        kind, module = "qwen2_vl_vit", qwen2_vl_vit
        vit_cfg = qwen2_vl_vit.Qwen2VLViTConfig(
            embed_dim=vis_cfg.get("embed_dim", 1280),
            depth=vis_cfg.get("depth", 32),
            num_heads=vis_cfg.get("num_heads", 16),
            patch_size=vis_cfg.get("patch_size", 14),
            temporal_patch_size=vis_cfg.get("temporal_patch_size", 2),
            spatial_merge_size=vis_cfg.get("spatial_merge_size", 2),
            mlp_ratio=vis_cfg.get("mlp_ratio", 4.0),
            hidden_size=llm_cfg.hidden_size,
            dtype=llm_cfg.dtype,
        )
    try:
        params = module.params_from_hf(state, vit_cfg, prefix="visual.", device=device)
    except (KeyError, ValueError):
        return None  # partial/unrecognized vision weights: LLM-only load
    return {"kind": kind, "cfg": vit_cfg, "params": params}


def _load_internvl_vision(state: dict, cfg_dict: dict, llm_cfg: LLMConfig, device):
    """InternViT and the ``mlp1`` projector of an ``internvl`` checkpoint (the
    hub's ``vision_model.`` / ``mlp1.`` layout) in ``llm_cfg.dtype``, or None
    when it carries none or only part of them (an LLM-only load)."""
    from .models.vision import internvl_vit

    if not any(k.startswith("vision_model.") for k in state):
        return None
    vis_cfg = cfg_dict.get("vision_config") or {}
    img, patch = vis_cfg.get("image_size", 448), vis_cfg.get("patch_size", 14)
    vit_cfg = internvl_vit.InternViTConfig(
        image_size=img if isinstance(img, int) else img[0],
        patch_size=patch if isinstance(patch, int) else patch[0],
        hidden_size=vis_cfg.get("hidden_size", 1024),
        intermediate_size=vis_cfg.get("intermediate_size", 4096),
        num_layers=vis_cfg.get("num_hidden_layers", 24),
        num_heads=vis_cfg.get("num_attention_heads", 16),
        attention_bias=bool(vis_cfg.get("qkv_bias", True)),
        use_qk_norm=bool(vis_cfg.get("qk_normalization", False)),
        text_hidden_size=llm_cfg.hidden_size,
        downsample_ratio=float(cfg_dict.get("downsample_ratio", 0.5)),
        dtype=llm_cfg.dtype,
    )
    try:
        params = internvl_vit.params_from_remote(state, vit_cfg, prefix="vision_model.", device=device)
        proj = internvl_vit.projector_from_remote(state, vit_cfg, prefix="mlp1.", device=device)
    except (KeyError, ValueError):
        return None  # partial/unrecognized vision weights: LLM-only load
    return {"kind": "internvl_vit", "cfg": vit_cfg, "params": params, "projector": proj}


def _siglip_config(vis_cfg: dict, default_image_size: int, dtype) -> "siglip.ViTConfig":
    from .models.vision import siglip

    img = vis_cfg.get("image_size", default_image_size)
    return siglip.ViTConfig(
        image_size=img if isinstance(img, int) else img[0],
        patch_size=vis_cfg.get("patch_size", 14),
        hidden_size=vis_cfg.get("hidden_size", 1152),
        intermediate_size=vis_cfg.get("intermediate_size", 4304),
        num_layers=vis_cfg.get("num_hidden_layers", 27),
        num_heads=vis_cfg.get("num_attention_heads", 16),
        dtype=dtype,
    )


def _load_minicpmv_vision(state: dict, cfg_dict: dict, llm_cfg: LLMConfig, device):
    """MiniCPM-V's SigLIP tower (``vpm.``, in ``llm_cfg.dtype``) at the
    checkpoint's own ``image_size`` (980 by default: the position table is
    not interpolated, so frames take that one size) and its perceiver
    ``resampler.`` (fp32, as in the JAX loader: ``query_num`` queries, the
    LLM width, heads of 128); None when the checkpoint carries none or only
    part of them (an LLM-only load)."""
    from .models.vision import minicpmv_frontend, siglip

    if not any(k.startswith("vpm.") for k in state):
        return None
    vit_cfg = _siglip_config(cfg_dict.get("vision_config") or {}, 980, llm_cfg.dtype)
    res_cfg = minicpmv_frontend.ResamplerConfig(num_queries=cfg_dict.get("query_num", 64),
                                                embed_dim=llm_cfg.hidden_size,
                                                num_heads=max(llm_cfg.hidden_size // 128, 1),
                                                kv_dim=vit_cfg.hidden_size)
    try:
        vit = siglip.params_from_hf(state, vit_cfg, prefix="vpm.", device=device)
        res = minicpmv_frontend.params_from_remote(state, res_cfg, device=device)
    except (KeyError, ValueError):
        return None  # partial/unrecognized vision weights: LLM-only load
    return {"kind": "minicpmv", "cfg": vit_cfg, "params": vit, "projector": {"params": res, "cfg": res_cfg}}


def _load_vision(family: str, state: dict, cfg_dict: dict, llm_cfg: LLMConfig, device):
    """The family's vision tower: SigLIP and the LLaVA projector for
    llava_video and llava_next_video, SigLIP and the resampler for minicpmv,
    the Qwen2-VL or Qwen2.5-VL tower for qwen2_vl, InternViT and its projector for
    internvl; None when the checkpoint carries no (recognizable) vision
    weights, and for nvila, whose connector the JAX loader does not load
    either (its caller passes the tower and connector)."""
    from .models.vision import siglip

    vis_cfg = cfg_dict.get("vision_config") or {}
    if family == "qwen2_vl":
        return _load_qwen2_vl_vision(state, vis_cfg, llm_cfg, device)
    if family == "internvl":
        return _load_internvl_vision(state, cfg_dict, llm_cfg, device)
    if family == "minicpmv":
        return _load_minicpmv_vision(state, cfg_dict, llm_cfg, device)
    if family not in ("llava_video", "llava_next_video") or not any("vision_tower" in k for k in state):
        return None
    try:
        tower_prefix = next(p for p in ("model.vision_tower.vision_tower.vision_model.", "vision_tower.vision_model.")
                            if any(k.startswith(p) for k in state))
        vit_cfg = _siglip_config(vis_cfg, 384, llm_cfg.dtype)
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
    tower, embeddings, norms and lm_head keep ``dtype``; the LLaVA projector
    and MiniCPM-V's resampler are fp32, as in the JAX loader, InternVL's
    ``mlp1`` takes ``dtype``. An InternVL checkpoint's InternLM2 goes through
    ``params_from_state_dict_internlm2``. A ``Qwen2_5_VLForConditionalGeneration``
    checkpoint loads as the ``qwen2_vl`` family with its Qwen2.5-VL tower; a
    ``Qwen2MoeForCausalLM`` one as ``llava_video`` with its MoE stacks (no
    tower).
    ``device=None`` loads onto the card and raises without one;
    ``device="cpu"`` asks for the CPU.
    """
    from .interface import FAMILIES, FrameFusionModel

    device = resolve_device(device)

    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    detected, llm_cfg = llm_config_from_hf(cfg_dict, dtype=dtype)
    family = family or detected
    if family not in FAMILIES:
        raise NotImplementedError(f"unknown model family {family!r}; the families are {sorted(FAMILIES)}")
    spec = FAMILIES[family]
    if llm_cfg.qkv_bias != spec.qkv_bias:
        raise ValueError(f"config qkv_bias={llm_cfg.qkv_bias} vs family {family}")
    state = load_state(checkpoint_dir)
    importer = params_from_state_dict_internlm2 if family == "internvl" else params_from_state_dict
    params = importer(state, llm_cfg, prefix=spec.llm_prefix, quantize=quantize, device=device)
    vision = _load_vision(family, state, cfg_dict, llm_cfg, device)
    return FrameFusionModel(family=family, cfg=llm_cfg, params=params, vision=vision)
