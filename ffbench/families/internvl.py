"""InternVL2.5 on the port: InternViT, the pixel shuffle and ``mlp1``, and the
InternLM2 decoder (no qkv bias), one ``FrameN: <image>`` line a frame."""

from __future__ import annotations

from .. import flops, weights
from ..generator import StubTokenizer
from .common import Program, apply_knobs, llm_config, program_decoder, torch_dtype

PORT_FAMILY = "internvl"


def tokens_per_frame(vision: dict) -> int:
    side = int((vision["image_size"] // vision["patch_size"]) * vision["downsample_ratio"])
    return side * side


def build(config: dict, seed: int, device) -> Program:
    from framefusion_tpu_torch.interface import FrameFusionModel
    from framefusion_tpu_torch.models.vision import internvl_vit
    from framefusion_tpu_torch.pipeline import TextPipeline

    dtype, v, text = torch_dtype(config), config["vision"], config["text"]
    vcfg = internvl_vit.InternViTConfig(
        image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"], layer_norm_eps=v["layer_norm_eps"], attention_bias=v["qkv_bias"],
        use_qk_norm=False, text_hidden_size=text["hidden_size"], downsample_ratio=v["downsample_ratio"], dtype=dtype)
    vit = weights.internvit_tower(v, seed, device, dtype)
    proj = weights.internvl_projector(v, text["hidden_size"], seed, device, dtype)
    params = program_decoder(config, seed, device)
    model = apply_knobs(FrameFusionModel(family=PORT_FAMILY, cfg=llm_config(text, dtype), params=params), config)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    return Program(pipe=pipe, port_family=PORT_FAMILY, image_size=v["image_size"])


def tower_work(config: dict, n_frames: int) -> dict:
    """The tower's operations for ``n_frames`` frames (every frame in one
    batch, CLS + patches a frame, as ``internvl_vit.extract_features``
    runs them) and kernel E's launches as (B, H, N, hd); then ``mlp1`` on
    the shuffled tokens."""
    v, d_llm = config["vision"], config["text"]["hidden_size"]
    n_tok = (v["image_size"] // v["patch_size"]) ** 2 + 1
    d, heads = v["hidden_size"], v["num_attention_heads"]
    ops = flops.vit_flops(n_frames, n_tok, d, v["intermediate_size"], v["num_hidden_layers"], heads,
                          3 * v["patch_size"] ** 2)
    unit = int(round(1 / v["downsample_ratio"])) ** 2
    ops += n_frames * tokens_per_frame(v) * 2 * (d * unit * d_llm + d_llm * d_llm)
    return {"flops": ops, "e_launches": [(n_frames, heads, n_tok, d // heads)] * v["num_hidden_layers"]}
