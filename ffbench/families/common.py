"""What the families share: the decoder's config, weights and set-up."""

from __future__ import annotations

import dataclasses

import torch

from .. import weights


@dataclasses.dataclass
class Program:
    pipe: object  # framefusion_tpu_torch.pipeline.TextPipeline
    port_family: str  # the port's family name (its preprocessing statistics)
    image_size: int  # the tower's input side: frames are resized to it

    @property
    def model(self):
        return self.pipe.model


def torch_dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["dtype"])


def llm_config(text: dict, dtype):
    """The port's ``LLMConfig`` for a configuration's ``text`` block."""
    from framefusion_tpu_torch.config import LLMConfig

    return LLMConfig(vocab_size=text["vocab_size"], hidden_size=text["hidden_size"],
                     intermediate_size=text["intermediate_size"], num_layers=text["num_hidden_layers"],
                     num_heads=text["num_attention_heads"], num_kv_heads=text["num_key_value_heads"],
                     head_dim=text.get("head_dim"), rms_norm_eps=text["rms_norm_eps"],
                     rope_theta=text["rope_theta"], tie_word_embeddings=False, qkv_bias=text["qkv_bias"],
                     dtype=dtype)


def program_decoder(config: dict, seed: int, device) -> dict:
    """The decoder's params as the port holds them after its set-up: the
    seeded draws, each matrix quantized as it arrives with the port's own
    ``quantize_weight`` (what ``from_checkpoint(..., quantize="int8")``
    does a layer at a time), so no more than one bf16 stack is ever
    resident beside the int8 ones."""
    from framefusion_tpu_torch.ops.quant import QUANTIZED_LAYER_WEIGHTS, quantize_weight

    quantize = config.get("quantize")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize {quantize!r}: the port quantizes to int8 or not at all")
    params: dict = {"layers": {}}
    for path, t in weights.decoder_tensors(config["text"], seed, device, torch_dtype(config)):
        if quantize == "int8" and path[0] == "layers" and path[1] in QUANTIZED_LAYER_WEIGHTS:
            t = quantize_weight(t)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params


def apply_knobs(model, config: dict):
    from framefusion_tpu_torch.interface import apply_framefusion

    ff = config["framefusion"]
    return apply_framefusion(model, ff["cost"], ff["similarity_lower_bound"], ff["ratio_lower_bound"])
