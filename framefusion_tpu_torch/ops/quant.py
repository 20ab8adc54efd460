"""Weight-only int8 quantization (port of ``framefusion_tpu.ops.quant``).

Per-output-channel symmetric int8: ``y = (x @ q8) * scale`` with
``scale_o = max_k |w[k, o]| / 127``; the scale factors out of the
contraction exactly, so the only error is the rounding of ``w``. A quantized
weight is the pair ``{"q8": int8 (..., K, O), "scale": fp32 (..., O)}``.
"""

from __future__ import annotations

import numpy as np
import torch

QUANTIZED_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_2d(w: torch.Tensor):
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q8, scale.squeeze(-2)


def quantize_weight(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: w (..., K, O) -> {"q8", "scale"}.

    Stacked (L, K, O) weights are quantized one layer at a time, so the fp32
    transient is one layer's copy (a whole 7B MLP stack in fp32 is 7.6 GB).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    if w.ndim == 2:
        q8, scale = _quantize_2d(w)
        return {"q8": q8, "scale": scale}
    q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q8[i], scale[i] = _quantize_2d(w[i])
    return {"q8": q8, "scale": scale}


def quantize_weight_host(w) -> dict:
    """Host (numpy) twin of :func:`quantize_weight` for quantize-on-load, so
    the device never holds the bf16 originals. Same math (fp32 max/127 per
    output channel, round half to even, clip to +-127). Returns numpy
    {"q8", "scale"}; the caller uploads."""
    w32 = np.asarray(w, dtype=np.float32)
    scale = np.maximum(np.max(np.abs(w32), axis=-2, keepdims=True) / 127.0, 1e-12)
    q8 = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    return {"q8": q8, "scale": scale.squeeze(-2).astype(np.float32)}


def quantize_params_int8(params: dict) -> dict:
    """Quantize the decoder matmul weights of a qwen2-layout param dict.

    Consumes ``params``: each weight entry is replaced in place, so the
    original frees tensor by tensor (peak = params + one tensor's int8
    copy). Embeddings, norms, biases and ``lm_head`` keep their dtype.
    """
    layers = params["layers"]
    for name in QUANTIZED_LAYER_WEIGHTS:
        w = layers.get(name)
        if w is not None and not isinstance(w, dict):
            layers[name] = quantize_weight(w)
            del w
    return params
