"""LLaVA-Video on the port: SigLIP to its layer -2, the LLaVA projector with
2x2 average pooling and a newline token a row, and the Qwen2 decoder."""

from __future__ import annotations

from .. import flops, weights
from ..generator import StubTokenizer
from .common import Program, apply_knobs, llm_config, program_decoder, torch_dtype

PORT_FAMILY = "llava_video"


def tokens_per_frame(vision: dict) -> int:
    side = (vision["image_size"] // vision["patch_size"]) // vision["pool_stride"]
    return side * (side + 1)


def build(config: dict, seed: int, device) -> Program:
    from framefusion_tpu_torch.interface import FrameFusionModel
    from framefusion_tpu_torch.models.vision import siglip
    from framefusion_tpu_torch.pipeline import TextPipeline

    dtype, v = torch_dtype(config), config["vision"]
    if v["feature_layer"] != -2 or v["pool_stride"] != 2:
        raise ValueError("the port's LLaVA frontend takes layer -2 and a 2x2 pool")
    vcfg = siglip.ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
                            intermediate_size=v["intermediate_size"], num_layers=v["num_hidden_layers"],
                            num_heads=v["num_attention_heads"], layer_norm_eps=v["layer_norm_eps"], dtype=dtype)
    vit = weights.siglip_tower(v, seed, device, dtype)
    proj = weights.llava_projector(v["hidden_size"], config["text"]["hidden_size"], seed, device, dtype)
    params = program_decoder(config, seed, device)
    model = apply_knobs(FrameFusionModel(family=PORT_FAMILY, cfg=llm_config(config["text"], dtype), params=params),
                        config)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    return Program(pipe=pipe, port_family=PORT_FAMILY, image_size=v["image_size"])


def tower_work(config: dict, n_frames: int) -> dict:
    """The tower's operations for ``n_frames`` frames, and kernel E's
    launches as (B, H, N, hd): frames run 16 at a time
    (``llava_frontend.encode_video``'s ``frame_batch``) through the blocks
    before the feature layer; then the projector on every patch."""
    v, d_llm = config["vision"], config["text"]["hidden_size"]
    n_tok = (v["image_size"] // v["patch_size"]) ** 2
    blocks = v["num_hidden_layers"] + v["feature_layer"] + 1
    d, heads = v["hidden_size"], v["num_attention_heads"]
    ops = flops.vit_flops(n_frames, n_tok, d, v["intermediate_size"], blocks, heads, 3 * v["patch_size"] ** 2)
    ops += n_frames * 2 * n_tok * (d * d_llm + d_llm * d_llm)
    batches = [min(16, n_frames - i) for i in range(0, n_frames, 16)]
    return {"flops": ops, "e_launches": [(b, heads, n_tok, d // heads) for b in batches for _ in range(blocks)]}
