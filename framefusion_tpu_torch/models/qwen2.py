"""Functional Qwen2-family decoder stack (port of ``framefusion_tpu.models.qwen2``).

Plain functions over a dict of parameters in the JAX package's layout:
layer weights are stacked along a leading layer axis, matrices are (K, N)
and applied as ``x @ w``, and an int8 weight-only matrix is the pair
``{"q8": int8 (L, K, N), "scale": fp32 (L, N)}``. The compression engine
(runtime/engine.py) composes ``layer_attention`` and ``layer_mlp`` around
its merge/prune events.

Architecture: RMSNorm, GQA attention with q/k/v bias, 1D rotary
embeddings, SwiGLU MLP, optional tied embeddings.

``attn_impl`` selects the prefill attention: ``"einsum"`` is the plain
reference; ``"flash"`` goes through the hand-written kernels
(ops/kernels/flash_prefill.py), whose wrappers run their plain versions for
CPU tensors. Decode with ``"flash"`` streams every projection through the
gemv kernels (ops/kernels/matvec_q8.py); decode attention is the plain
masked einsum in both cases, as in the JAX engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LLMConfig
from ..ops.attention import causal_attention_einsum, decode_attention, last_rows_importance
from ..ops.kernels import flash_prefill, matvec_q8
from ..ops.rope import apply_rope, rope_cos_sin

ATTN_IMPLS = ("einsum", "flash")


# ---------------------------------------------------------------------------
# Parameters


def init_params(cfg: LLMConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal weights drawn from ``generator`` directly in
    ``cfg.dtype`` on ``device`` (the generator's device by default): a 7B
    set never exists in fp32 (w_down alone would be 7.6 GB)."""
    device = torch.device(device) if device is not None else generator.device
    hd = cfg.head_dim_

    def norm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    n_l, d, i = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    layers = {
        "ln1": ones(n_l, d),
        "ln2": ones(n_l, d),
        "wq": norm(n_l, d, hq * hd),
        "wk": norm(n_l, d, hk * hd),
        "wv": norm(n_l, d, hk * hd),
        "wo": norm(n_l, hq * hd, d),
        "w_gate": norm(n_l, d, i),
        "w_up": norm(n_l, d, i),
        "w_down": norm(n_l, i, d),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros(n_l, hq * hd)
        layers["bk"] = zeros(n_l, hk * hd)
        layers["bv"] = zeros(n_l, hk * hd)
    params = {"embed": norm(cfg.vocab_size, d), "layers": layers, "final_norm": ones(d)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm(d, cfg.vocab_size)
    return params


def params_from_numpy(tree, device=None):
    """The JAX package's param pytree (fetched as numpy with
    ``jax.device_get``) as this package's params: same keys and layouts,
    int8 pairs included. bf16 arrays stay bf16 (through an exact fp32
    copy: torch reads no numpy bf16), other floats become fp32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy()).to(device)
    want = torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=want)


def layer_slice(layers: dict, idx: int) -> dict:
    """One layer's parameters (views, no copies)."""
    return {
        name: ({"q8": w["q8"][idx], "scale": w["scale"][idx]} if isinstance(w, dict) else w[idx])
        for name, w in layers.items()
    }


# ---------------------------------------------------------------------------
# Blocks


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def positions_cos_sin(position_ids: torch.Tensor, cfg: LLMConfig):
    return rope_cos_sin(position_ids, cfg.head_dim_, cfg.rope_theta)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) @ int8 (K, N) -> int32. On the card
    ``torch._int_mm`` (which takes M > 16 and K, N multiples of 8; short
    inputs are padded with zero rows); on the CPU an int32 matmul."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    return torch._int_mm(a, b)[:m]


def mm(x: torch.Tensor, w, w8a8: bool = False) -> torch.Tensor:
    """x @ w for a dense (K, O) matrix or an int8 pair {"q8", "scale"}; the
    per-output-channel scale factors out of the contraction exactly.

    ``w8a8=True`` (with an int8 pair) also quantizes the activations per row
    (symmetric int8, scale rowmax/127) and contracts int8 x int8 -> int32
    exactly, then descales; a dense ``w`` ignores it."""
    if isinstance(w, dict):
        if w8a8:
            xf = x.to(torch.float32)
            s_x = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
            x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
            acc = _int8_matmul(x_q.reshape(-1, x.shape[-1]), w["q8"]).reshape(*x.shape[:-1], -1)
            return (acc.to(torch.float32) * s_x * w["scale"]).to(x.dtype)
        y = torch.matmul(x, w["q8"].to(x.dtype)).to(torch.float32)
        return (y * w["scale"]).to(x.dtype)
    return x @ w


def _scale_row(w, l: int):
    return w["scale"][l] if isinstance(w, dict) else None


def _stack(w):
    return w["q8"] if isinstance(w, dict) else w


def mv_stacked(x: torch.Tensor, w_stack, l: int) -> torch.Tensor:
    """Decode matvec straight from the (L, K, N) stack (kernel C)."""
    y = matvec_q8.matvec_stacked(x, _stack(w_stack), l)
    s = _scale_row(w_stack, l)
    return (y * s if s is not None else y).to(x.dtype)


def mv_stacked_qkv(x: torch.Tensor, wq, wk, wv, l: int):
    """q/k/v decode matvecs in one launch (kernel C with three stacks)."""
    ys = matvec_q8.matvec_stacked_qkv(x, _stack(wq), _stack(wk), _stack(wv), l)
    outs = []
    for y, w in zip(ys, (wq, wk, wv)):
        s = _scale_row(w, l)
        outs.append((y * s if s is not None else y).to(x.dtype))
    return tuple(outs)


def mv_stacked_gateup(x: torch.Tensor, wg, wu, l: int) -> torch.Tensor:
    """silu(x@wg) * (x@wu) for decode, both stacks in one launch (kernel D);
    the int8 scales multiply before the nonlinearity, as ``mm`` orders them."""
    sg = wg["scale"] if isinstance(wg, dict) else None
    su = wu["scale"] if isinstance(wu, dict) else None
    return matvec_q8.matvec_stacked_gateup(x, _stack(wg), _stack(wu), sg, su, l).to(x.dtype)


def _project_qkv(lp: dict, x: torch.Tensor, cfg: LLMConfig):
    s = x.shape[0]
    hd = cfg.head_dim_
    q, k, v = mm(x, lp["wq"]), mm(x, lp["wk"]), mm(x, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (
        q.reshape(s, cfg.num_heads, hd),
        k.reshape(s, cfg.num_kv_heads, hd),
        v.reshape(s, cfg.num_kv_heads, hd),
    )


def attention_kernel_dispatch(q, k, v, attn_impl: str, capture_num: int, valid_len, key_valid):
    """Attention plus, when ``capture_num > 0``, the prune importance of the
    last ``capture_num`` live rows. Returns (attn (S, Hq, D), importance-or-None)."""
    if attn_impl == "flash":
        if capture_num:
            return flash_prefill.flash_causal_attention_importance(
                q, k, v, valid_len, capture_num, key_valid=key_valid)
        return flash_prefill.flash_causal_attention(q, k, v, key_valid=key_valid), None
    if attn_impl != "einsum":
        raise ValueError(f"unknown attention impl: {attn_impl}")
    attn = causal_attention_einsum(q, k, v, key_valid=key_valid)
    importance = None
    if capture_num:
        importance = last_rows_importance(q, k, capture_num, valid_len, key_valid=key_valid)
    return attn, importance


def layer_attention(lp: dict, h, cos, sin, cfg: LLMConfig, *, attn_impl: str = "einsum",
                    capture_num: int = 0, valid_len=None, key_valid=None):
    """Pre-norm attention block with residual.

    Returns (h_out, k, v, importance-or-None); ``key_valid`` masks dead keys
    in the mask-only compression phase.
    """
    x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(lp, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    attn, importance = attention_kernel_dispatch(q, k, v, attn_impl, capture_num, valid_len, key_valid)
    h_out = h + mm(attn.reshape(h.shape[0], -1), lp["wo"])
    return h_out, k, v, importance


def layer_mlp(lp: dict, h: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Pre-norm SwiGLU MLP block with residual."""
    x = rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
    gated = torch.nn.functional.silu(mm(x, lp["w_gate"])) * mm(x, lp["w_up"])
    return h + mm(gated, lp["w_down"])


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids]


def final_logits(params: dict, h: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    x = rmsnorm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        return (x @ params["embed"].T).to(torch.float32)
    return mm(x, params["lm_head"]).to(torch.float32)


# ---------------------------------------------------------------------------
# Whole-stack programs (dense path; the tail of the compressed prefill)


def run_layers(params: dict, h, cos, sin, cfg: LLMConfig, *, start_layer: int = 0,
               stop_layer=None, attn_impl: str = "einsum", want_caches: bool = True):
    """Run layers [start_layer, stop_layer) over ``h``; returns (h, k_all, v_all).

    ``k_all``/``v_all`` are (L, S, Hk, hd) with zeros outside the range, or
    None with ``want_caches=False``.
    """
    s = h.shape[0]
    stop_layer = cfg.num_layers if stop_layer is None else stop_layer
    k_all = v_all = None
    if want_caches:
        k_all = torch.zeros((cfg.num_layers, s, cfg.num_kv_heads, cfg.head_dim_), dtype=cfg.dtype, device=h.device)
        v_all = torch.zeros_like(k_all)
    for l in range(start_layer, stop_layer):
        lp = layer_slice(params["layers"], l)
        h, k, v, _ = layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl)
        h = layer_mlp(lp, h, cfg)
        if want_caches:
            k_all[l] = k
            v_all[l] = v
    return h, k_all, v_all


def dense_prefill(params: dict, input_embeds, position_ids, cfg: LLMConfig, *,
                  attn_impl: str = "einsum", want_caches: bool = True):
    """Full dense prefill. Returns (logits_last (V,), k_all, v_all)."""
    cos, sin = positions_cos_sin(position_ids, cfg)
    h, k_all, v_all = run_layers(params, input_embeds, cos, sin, cfg, attn_impl=attn_impl,
                                 want_caches=want_caches)
    return final_logits(params, h[-1:], cfg)[0], k_all, v_all


def _pool_view(pool: torch.Tensor, l: int, s_view: int) -> torch.Tensor:
    """Layer ``l``'s cache restricted to its first ``s_view`` rows. Tail
    layers never hold more than the post-compression bucket, so reading only
    that prefix is identical (rows past a layer's length are masked either
    way) and skips the padded read of the full-prompt pool."""
    return pool[l, :s_view]


def decode_step(params: dict, token_embed, position_id: int, k_pool, v_pool, cache_lens,
                cfg: LLMConfig, attn_impl: str = "einsum", tail_split=None):
    """One decode step against a padded per-layer cache pool.

    Args:
        token_embed: (D,) current-token embedding.
        position_id: rotary position (int).
        k_pool, v_pool: (L, S_pad, Hk, hd), updated IN PLACE (the JAX
            version returns new arrays; here the pools are owned by the
            decode loop, so an in-place row write saves a pool copy per step).
        cache_lens: per-layer valid entries excluding this token (ints).
        tail_split: optional ``(P, tail_s)`` — layers >= P attend only the
            pool's first ``tail_s`` rows.

    Returns:
        (logits (V,) fp32, k_pool, v_pool, cache_lens + 1).
    """
    cos, sin = positions_cos_sin(torch.tensor([position_id], device=token_embed.device), cfg)
    h = token_embed[None, :]
    use_mv = attn_impl == "flash"
    layers = params["layers"]
    hd = cfg.head_dim_
    s_full = k_pool.shape[1]
    if tail_split is not None and tail_split[1] >= s_full:
        tail_split = None
    for l in range(cfg.num_layers):
        s_view = tail_split[1] if tail_split is not None and l >= tail_split[0] else s_full
        lp = layer_slice(layers, l)
        x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        if use_mv:
            q, k, v = mv_stacked_qkv(x, layers["wq"], layers["wk"], layers["wv"], l)
            if cfg.qkv_bias:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            q = q.reshape(1, cfg.num_heads, hd)
            k = k.reshape(1, cfg.num_kv_heads, hd)
            v = v.reshape(1, cfg.num_kv_heads, hd)
        else:
            q, k, v = _project_qkv(lp, x, cfg)
        q, k = apply_rope(q, k, cos, sin)
        length = int(cache_lens[l])
        k_pool[l, length] = k[0].to(k_pool.dtype)
        v_pool[l, length] = v[0].to(v_pool.dtype)
        attn = decode_attention(q[0], _pool_view(k_pool, l, s_view), _pool_view(v_pool, l, s_view), length + 1)
        if use_mv:
            h = h + mv_stacked(attn.reshape(1, -1), layers["wo"], l)
            x2 = rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
            gated = mv_stacked_gateup(x2, layers["w_gate"], layers["w_up"], l)
            h = h + mv_stacked(gated.to(h.dtype), layers["w_down"], l)
        else:
            h = h + mm(attn.reshape(1, -1), lp["wo"])
            h = layer_mlp(lp, h, cfg)
    logits = final_logits(params, h, cfg)[0]
    return logits, k_pool, v_pool, [int(n) + 1 for n in cache_lens]
