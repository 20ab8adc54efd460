"""Weight-only int8 quantization (port of ``framefusion_tpu.ops.quant``).

Per-output-channel symmetric int8: ``y = (x @ q8) * scale`` with
``scale_o = max_k |w[k, o]| / 127``; the scale factors out of the
contraction exactly, so the only error is the rounding of ``w``. A quantized
weight is the pair ``{"q8": int8 (..., K, O), "scale": fp32 (..., O)}``.
"""

from __future__ import annotations

import numpy as np
import torch

# w_gate / w_up / w_down are the dense MLP stacks (L, K, O), or on a MoE
# stack the expert stacks (L, E, K, O); sw_* are the MoE shared expert. The
# router and shared_gate keep their dtype (the router's fp32 softmax decides
# the routing), as in JAX.
QUANTIZED_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "sw_gate", "sw_up", "sw_down")


def _quantize_2d(w: torch.Tensor):
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q8, scale.squeeze(-2)


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: w (..., K, O) -> {"q8", "scale"}.

    Stacked (L, K, O) weights are quantized one layer at a time, and MoE
    expert stacks (L, E, K, O) one (layer, expert) matrix at a time, so the
    fp32 transient is one matrix's copy (a whole 7B MLP stack in fp32 is 7.6
    GB). ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if w.ndim == 2:
        q8, scale = _quantize_2d(w)
        return {"q8": q8, "scale": scale}
    q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32, device=w.device)
    flat_w, flat_q, flat_s = w.reshape(-1, *w.shape[-2:]), q8.view(-1, *w.shape[-2:]), scale.view(-1, w.shape[-1])
    for i in range(flat_w.shape[0]):
        flat_q[i], flat_s[i] = _quantize_2d(flat_w[i])
    return {"q8": q8, "scale": scale}


def dequantize_weight(wq: dict, dtype=torch.float32) -> torch.Tensor:
    return (wq["q8"].to(torch.float32) * wq["scale"][..., None, :]).to(dtype)


def quantize_weight_host(w) -> dict:
    """Host (numpy) twin of :func:`quantize_weight`, JAX's quantize-on-load
    (the port's loader quantizes on the device with ``quantize_weight``
    itself). Same math (fp32 max/127 per output channel, round half to
    even, clip to +-127). Returns numpy {"q8", "scale"}."""
    w32 = np.asarray(w, dtype=np.float32)
    scale = np.maximum(np.max(np.abs(w32), axis=-2, keepdims=True) / 127.0, 1e-12)
    q8 = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    return {"q8": q8, "scale": scale.squeeze(-2).astype(np.float32)}


def quantize_head(w: torch.Tensor) -> dict:
    """An int8 LM head (D, V), its columns padded with zeros to a multiple of
    16 (kernel C reads int8 rows 16 bytes at a time): the pad columns' scales
    are 1e-12 and their logits 0, and ``qwen2.final_logits`` slices them off,
    so the padding is exact. Qwen2's vocabularies (151,936, 152,064) need no
    pad; InternLM2's 92,553 takes 7."""
    pad = -w.shape[1] % 16
    return quantize_weight(torch.nn.functional.pad(w, (0, pad)) if pad else w)


def quantize_params_int8(params: dict, quantize_lm_head: bool = False) -> dict:
    """Quantize the decoder matmul weights of a qwen2-layout param dict.

    Consumes ``params``: each weight entry is replaced in place, so the
    original frees tensor by tensor (peak = params + one tensor's int8
    copy). Embeddings, norms and biases keep their dtype; ``lm_head`` too
    unless ``quantize_lm_head`` (then through ``quantize_head``, padded).
    """
    layers = params["layers"]
    for name in QUANTIZED_LAYER_WEIGHTS:
        w = layers.get(name)
        if w is not None and not isinstance(w, dict):
            layers[name] = quantize_weight(w)
            del w
    if quantize_lm_head and "lm_head" in params and not isinstance(params["lm_head"], dict):
        params["lm_head"] = quantize_head(params.pop("lm_head"))
    return params
