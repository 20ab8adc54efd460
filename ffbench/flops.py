"""Operations and bytes from shapes, and the card's peaks: the yardstick of the rooflines and ``mfu``.

The arithmetic is copied from ``framefusion_tpu_torch/kernel_bench.py``
(``attn_flops``, ``layer_params``, ``prefill_ops``, ``matvec_bytes``) so that
a change to the program cannot change what its rooflines count.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def attn_flops(s: int, hq: int, d: int) -> float:
    """Causal attention's operations: QK^T and PV over the s(s+1)/2 pairs
    (``kernel_bench.attn_flops``)."""
    return 4 * hq * d * s * (s + 1) / 2


def e_flops(b: int, h: int, n: int, hd: int) -> float:
    """Kernel E (bidirectional attention) over (B, N, H, hd): 4 B H N^2 hd."""
    return 4.0 * b * h * n * n * hd


def layer_params(text: dict) -> tuple:
    """One dense decoder layer's GEMM weights: (q, k, v, o; gate, up, down)
    (``kernel_bench.layer_params``)."""
    d, hq, hk = text["hidden_size"], text["num_attention_heads"], text["num_key_value_heads"]
    hd = text.get("head_dim") or d // hq
    return d * (hq + 2 * hk) * hd + hq * hd * d, 3 * d * text["intermediate_size"]


def dense_prefill_flops(text: dict, s: int) -> float:
    """A dense prefill of ``s`` rows: every layer's GEMMs and causal
    attention, and the LM head on the last row (``kernel_bench.prefill_ops``
    with no event)."""
    p_attn, p_mlp = layer_params(text)
    d, hq = text["hidden_size"], text["num_attention_heads"]
    hd = text.get("head_dim") or d // hq
    per_layer = 2 * s * (p_attn + p_mlp) + attn_flops(s, hq, hd)
    return text["num_hidden_layers"] * per_layer + 2 * d * text["vocab_size"]


def decode_flops_per_token(text: dict) -> float:
    """2 x the decoder's parameters (layers and head) a generated token."""
    p_attn, p_mlp = layer_params(text)
    return 2.0 * (text["num_hidden_layers"] * (p_attn + p_mlp) + text["hidden_size"] * text["vocab_size"])


def cd_bytes_per_step(text: dict) -> float:
    """Kernels C and D in one decode step: every layer's int8 q, k, v, o,
    gate, up and down weights and their fp32 scales, read once
    (``kernel_bench.matvec_bytes`` without the activation rows)."""
    d, hq, hk, i = text["hidden_size"], text["num_attention_heads"], text["num_key_value_heads"], \
        text["intermediate_size"]
    hd = text.get("head_dim") or d // hq
    out_cols = [hq * hd, hk * hd, hk * hd, d, i, i, d]
    in_rows = [d, d, d, hq * hd, d, d, i]
    per_layer = sum(k * n for k, n in zip(in_rows, out_cols)) + 4 * sum(out_cols)
    return float(text["num_hidden_layers"] * per_layer)


def decode_weight_bytes(text: dict) -> float:
    """Bytes one decode step reads at least: the int8 layer weights with
    their scales (``cd_bytes_per_step``), the norms and the bf16 LM head."""
    d = text["hidden_size"]
    norms = 2 * (2 * text["num_hidden_layers"] * d + d)
    return cd_bytes_per_step(text) + norms + 2.0 * d * text["vocab_size"]


def vit_flops(n_img: int, tokens: int, d: int, inter: int, layers: int, heads: int, patch_in: int) -> float:
    """A ViT tower over ``n_img`` images of ``tokens`` tokens: the patch
    embedding, and each block's q, k, v, o and MLP GEMMs and its
    bidirectional attention."""
    per_block = 2 * tokens * (4 * d * d + 2 * d * inter) + e_flops(1, heads, tokens, d // heads)
    return n_img * (2 * tokens * patch_in * d + layers * per_block)
