"""Functional Qwen2-family decoder stack (port of ``framefusion_tpu.models.qwen2``).

Plain functions over a dict of parameters in the JAX package's layout:
layer weights are stacked along a leading layer axis, matrices are (K, N)
and applied as ``x @ w``, and an int8 weight-only matrix is the pair
``{"q8": int8 (L, K, N), "scale": fp32 (L, N)}``. The compression engine
(runtime/engine.py) composes ``layer_attention`` and ``layer_mlp`` around
its merge/prune events.

Architecture: RMSNorm, GQA attention with q/k/v bias, 1D rotary
embeddings, SwiGLU MLP, optional tied embeddings. A Qwen2-MoE stack
(``cfg.is_moe``) carries per layer a router, (E, K, N) expert stacks and a
shared expert: the prefill routes through ``models/moe.sparse_mlp`` at the
capacity of each call's physical row count, and every decode-side program
runs ``moe_decode_mlp``, which reads the k routed experts' weights in place
(kernels C and D with a stack index a row, on the card) instead of
dispatching the token.

An int8 ``lm_head`` (``ops/quant.quantize_head``, padded to a multiple of
16 columns) is read by kernel C as a one-layer stack in the decode-side
programs; the prefill takes ``mm``, as JAX does. The logits are sliced back
to ``vocab_size`` either way.

``attn_impl`` selects the prefill attention: ``"einsum"`` is the plain
reference; ``"flash"`` goes through the hand-written kernels
(ops/kernels/flash_prefill.py), whose wrappers run their plain versions for
CPU tensors. The decode-side programs (``decode_step``, ``verify_step`` and
their batched forms) map the JAX package's values so:

=============  ==============  ===============================================
JAX            port            what runs
=============  ==============  ===============================================
``"jax"``      ``"einsum"``    plain projections, plain masked attention
``"mv-jax"``   ``"flash"``     projections streamed through the gemv kernels
                               C/D (ops/kernels/matvec_q8.py), plain masked
                               attention; the engines' decode, as in JAX
``"pallas"``   ``"ragged"``    C/D plus the ragged decode-attention kernel G
                               (ops/kernels/decode_attention.py) on the same
                               pool view; ``decode_step`` only
=============  ==============  ===============================================

In ``decode_step_batch`` JAX's ``"pallas"`` is the port's ``"flash"`` (C/D
with B rows; the attention stays plain torch, as it is XLA in JAX). The
JAX microbenchmark knob ``"stub"`` and the ``FF_VERIFY_MV`` switch are not
ported: ``verify_step``'s ``attn_impl`` takes the switch's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import LLMConfig
from ..ops.attention import (causal_attention, causal_attention_einsum, decode_attention, last_rows_importance,
                             verify_attention)
from ..ops.kernels import flash_prefill, matvec_q8
from ..ops.kernels.decode_attention import ragged_decode_attention
from ..ops.rope import apply_rope, mrope_cos_sin, rope_cos_sin
from ..parallel import collectives
from ..weights import resolve_device
from . import moe

ATTN_IMPLS = ("einsum", "flash")  # prefill, the engines, verify and batched decode
DECODE_ATTN_IMPLS = ATTN_IMPLS + ("ragged",)  # decode_step


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
    }
    if cfg.is_moe:
        # JAX's layout: the layer axis, then the expert axis.
        e, mi, si = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
        layers.update({"router": norm(n_l, d, e), "w_gate": norm(n_l, e, d, mi), "w_up": norm(n_l, e, d, mi),
                       "w_down": norm(n_l, e, mi, d), "sw_gate": norm(n_l, d, si), "sw_up": norm(n_l, d, si),
                       "sw_down": norm(n_l, si, d), "shared_gate": norm(n_l, d, 1)})
    else:
        layers.update({"w_gate": norm(n_l, d, i), "w_up": norm(n_l, d, i), "w_down": norm(n_l, i, d)})
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
    copy: torch reads no numpy bf16), other floats become fp32. ``device``:
    the card when None (which raises without one, as the loaders do);
    ``"cpu"`` for the CPU."""
    device = resolve_device(device)
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


def pos_tokens(position_ids, device) -> torch.Tensor:
    """(S,) or (3, S) positions -> token-major (S, P) int64 on ``device``:
    the layout every gather, pad and compaction takes along its token axis."""
    if not isinstance(position_ids, torch.Tensor):
        position_ids = torch.from_numpy(np.asarray(position_ids))
    pos = position_ids.to(device=device, dtype=torch.int64)
    return pos.reshape(-1, 1) if pos.ndim == 1 else pos.T


def token_cos_sin(pos_tok: torch.Tensor, cfg: LLMConfig):
    """cos/sin from token-major positions (..., S, P), the layout the
    executors carry through padding and compaction: P = 1 is 1D RoPE, P = 3
    the mRoPE streams. Returns (..., S, head_dim) tables."""
    if pos_tok.shape[-1] == 1:
        return rope_cos_sin(pos_tok[..., 0], cfg.head_dim_, cfg.rope_theta)
    if cfg.mrope_section is None:
        raise ValueError("3-stream positions need an mRoPE config (mrope_section)")
    return mrope_cos_sin(pos_tok.movedim(-1, 0), cfg.head_dim_, cfg.rope_theta, cfg.mrope_section)


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
    rows = x.shape[:-1]
    hd = cfg.head_dim_
    q, k, v = mm(x, lp["wq"]), mm(x, lp["wk"]), mm(x, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (
        q.reshape(*rows, cfg.num_heads, hd),
        k.reshape(*rows, cfg.num_kv_heads, hd),
        v.reshape(*rows, cfg.num_kv_heads, hd),
    )


def attention_kernel_dispatch(q, k, v, attn_impl: str, capture_num: int, valid_len, key_valid):
    """Attention plus, when ``capture_num > 0``, the prune importance of the
    last ``capture_num`` live rows. Returns (attn (S, Hq, D), importance-or-None).
    The attention is ``ops.attention.causal_attention``'s, unless kernel A
    computes both at once. Under a tensor group the importance (a mean over this rank's heads) is
    made the mean over all heads."""
    if capture_num and attn_impl == "flash":
        attn, importance = flash_prefill.flash_causal_attention_importance(
            q, k, v, valid_len, capture_num, key_valid=key_valid)
        return attn, collectives.tensor_mean(importance)
    attn = causal_attention(q, k, v, attn_impl, key_valid=key_valid)
    importance = None
    if capture_num:
        importance = collectives.tensor_mean(
            last_rows_importance(q, k, capture_num, valid_len, key_valid=key_valid))
    return attn, importance


def layer_attention(lp: dict, h, cos, sin, cfg: LLMConfig, *, attn_impl: str = "einsum",
                    capture_num: int = 0, valid_len=None, key_valid=None):
    """Pre-norm attention block with residual.

    Returns (h_out, k, v, importance-or-None); ``key_valid`` masks dead keys
    in the mask-only compression phase. A batch ``h`` (B, S, D) (the
    training step) runs its projections batched and the plain ``"einsum"``
    core per sequence under ``vmap``, which no collective enters. Under a
    tensor group the normed input's gradient is summed over the group
    (``collectives.tensor_input``; nothing without autograd).
    """
    x = collectives.tensor_input(rmsnorm(h, lp["ln1"], cfg.rms_norm_eps))
    q, k, v = _project_qkv(lp, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    if h.ndim == 3:
        if attn_impl != "einsum" or capture_num or key_valid is not None:
            raise ValueError("a batch runs the plain einsum attention, with no capture and no key mask")
        attn, importance = torch.func.vmap(causal_attention_einsum)(q, k, v), None
    else:
        attn, importance = attention_kernel_dispatch(q, k, v, attn_impl, capture_num, valid_len, key_valid)
    h_out = h + collectives.tensor_sum(mm(attn.reshape(*h.shape[:-1], -1), lp["wo"]))
    return h_out, k, v, importance


def layer_mlp(lp: dict, h: torch.Tensor, cfg: LLMConfig, live=None) -> torch.Tensor:
    """Pre-norm MLP block with residual: SwiGLU, or the Qwen2-MoE sparse
    block when the layer carries a router.

    ``live`` (bool (S,), or (B, S) for a batched (B, S, D) ``h``) keeps dead
    and pad rows out of the expert routing, so they claim no capacity slot;
    the capacity comes from the rows ``h`` physically holds (JAX's
    ``layer_mlp``). A batch routes each sequence on its own. The dense MLP
    is per token and ignores ``live``. Under a tensor group the normed
    input's gradient is summed over the group, as in ``layer_attention``."""
    if "router" in lp:
        if h.ndim == 3:
            return torch.stack([layer_mlp(lp, h[i], cfg, None if live is None else live[i])
                                for i in range(h.shape[0])])
        x = collectives.tensor_input(rmsnorm(h, lp["ln2"], cfg.rms_norm_eps))
        y, _ = moe.sparse_mlp(lp, x, num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                              norm_topk_prob=cfg.norm_topk_prob,
                              capacity=moe.moe_prefill_capacity(x.shape[0], cfg), live=live)
        return h + y
    x = collectives.tensor_input(rmsnorm(h, lp["ln2"], cfg.rms_norm_eps))
    gated = torch.nn.functional.silu(mm(x, lp["w_gate"])) * mm(x, lp["w_up"])
    return h + collectives.tensor_sum(mm(gated, lp["w_down"]))


def _gather_expert(w, idx):
    """The experts ``idx`` (any shape) of one layer's (E, K, O) stack, or of
    both members of an int8 pair: (..., K, O) (and scales (..., O))."""
    if isinstance(w, dict):
        return {"q8": w["q8"][idx], "scale": w["scale"][idx]}
    return w[idx]


def moe_decode_mlp(lp: dict, h: torch.Tensor, cfg: LLMConfig, layers=None, l: int = 0) -> torch.Tensor:
    """The MoE MLP block of R decode rows h (R, D), each row exact (no
    capacity): the router's top-k experts' weights are read, not the token
    dispatched, as JAX's ``moe_decode_mlp`` (vmapped over the rows) does.

    With ``layers`` (the whole stacks) and ``l``, the routed experts run on
    kernels C and D with a device stack index a row (``l * E + expert``),
    so the weights are read in place and nothing is read back to the host;
    the shared expert takes the stacked matvecs. Without, the plain path
    gathers the experts (JAX's arithmetic)."""
    x = rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
    r, k = x.shape[0], cfg.num_experts_per_tok
    weights, idx, _ = moe.top_k_experts(x, lp["router"], k, cfg.norm_topk_prob)  # (R, k)
    # Under an expert split every rank routes every row over all E experts
    # and computes the choices of its own E / n (a stack index local to its
    # stacks); the others' choices keep their row, so the row count (and a
    # captured graph) is fixed, and add zero.
    shard = collectives.expert_shard(cfg.num_experts)
    n_stack, mine, local = cfg.num_experts, None, idx
    if shard is not None:
        _, lo, n_stack = shard
        mine = (idx >= lo) & (idx < lo + n_stack)
        local = torch.where(mine, idx - lo, torch.zeros_like(idx))
    if layers is None:
        xe = x[:, None, None, :]
        gated = (torch.nn.functional.silu(moe.expert_matmul(xe, _gather_expert(lp["w_gate"], local)))
                 * moe.expert_matmul(xe, _gather_expert(lp["w_up"], local)))
        ye = moe.expert_matmul(gated, _gather_expert(lp["w_down"], local))[:, :, 0]  # (R, k, D)
        shared = mm(torch.nn.functional.silu(mm(x, lp["sw_gate"])) * mm(x, lp["sw_up"]), lp["sw_down"])
    else:
        rows = (local + l * n_stack).reshape(-1).to(torch.int32)  # row r * k + j: expert idx[r, j]
        xr = x[:, None, :].repeat(1, k, 1).reshape(r * k, -1)  # a copy: the kernels take contiguous rows
        wg, wu, wd = layers["w_gate"], layers["w_up"], layers["w_down"]
        sg, su = (w["scale"] if isinstance(w, dict) else None for w in (wg, wu))
        gated = matvec_q8.matvec_routed_gateup(xr, _stack(wg), _stack(wu), sg, su, rows)
        yd = matvec_q8.matvec_routed(gated.to(x.dtype), _stack(wd), rows)
        if isinstance(wd, dict):
            yd = yd * wd["scale"].reshape(-1, wd["scale"].shape[-1])[rows.long()]
        ye = yd.to(x.dtype).reshape(r, k, -1)
        shared = mv_stacked(mv_stacked_gateup(x, layers["sw_gate"], layers["sw_up"], l), layers["sw_down"], l)
    if mine is not None:
        ye = torch.where(mine[..., None], ye, torch.zeros_like(ye))
    y = (ye * weights[..., None]).sum(dim=1)
    return h + moe.combine_shared(y, torch.sigmoid(x @ lp["shared_gate"]) * shared)


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``input_ids``; a 0-d id gives one (D,) row, read
    with ``index_select`` (indexing by a 0-d tensor reads it to the host)."""
    if collectives.current() is not None:  # a vocabulary split: a masked lookup, then a sum
        return collectives.embed_rows(params["embed"], torch.as_tensor(input_ids, device=params["embed"].device))
    if isinstance(input_ids, torch.Tensor) and input_ids.ndim == 0:
        return params["embed"].index_select(0, input_ids.reshape(1))[0]
    return params["embed"][input_ids]


def head_logits(params: dict, h: torch.Tensor, cfg: LLMConfig, use_mv: bool = False) -> torch.Tensor:
    """fp32 logits of the rows of ``h`` over this rank's vocabulary slice
    (the whole vocabulary without a tensor group; a padded head's columns
    included). ``use_mv`` (the decode-side programs, (R, D) rows) reads an
    int8 head with kernel C as a one-layer stack."""
    x = collectives.tensor_input(rmsnorm(h, params["final_norm"], cfg.rms_norm_eps))
    if cfg.tie_word_embeddings:
        return (x @ params["embed"].T).to(torch.float32)
    if isinstance(params["lm_head"], dict) and use_mv:
        head = params["lm_head"]
        return matvec_q8.matvec_q8(x.to(torch.bfloat16), head["q8"], head["scale"])
    return mm(x, params["lm_head"]).to(torch.float32)


def final_logits(params: dict, h: torch.Tensor, cfg: LLMConfig, use_mv: bool = False) -> torch.Tensor:
    """fp32 logits of the rows of ``h`` (``head_logits``), a tensor group's
    vocabulary slices gathered and a padded head's extra columns cut."""
    return collectives.vocab_gather(head_logits(params, h, cfg, use_mv))[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# Whole-stack programs (dense path; the tail of the compressed prefill)


def run_layers(params: dict, h, cos, sin, cfg: LLMConfig, *, start_layer: int = 0,
               stop_layer=None, attn_impl: str = "einsum", want_caches: bool = True, valid_len=None):
    """Run layers [start_layer, stop_layer) over ``h``; returns (h, k_all, v_all).

    ``k_all``/``v_all`` are (L, S, Hk, hd) with zeros outside the range, or
    None with ``want_caches=False``. ``valid_len`` marks trailing pad rows
    (a compacted bucket); only a MoE stack reads it: pad rows claim no
    expert slot.
    """
    s = h.shape[0]
    stop_layer = cfg.num_layers if stop_layer is None else stop_layer
    live = None
    if cfg.is_moe and valid_len is not None:
        live = torch.arange(s, device=h.device) < valid_len
    k_all = v_all = None
    if want_caches:
        k_all = torch.zeros((cfg.num_layers, s, cfg.num_kv_heads, cfg.head_dim_), dtype=cfg.dtype, device=h.device)
        v_all = torch.zeros_like(k_all)
    for l in range(start_layer, stop_layer):
        lp = layer_slice(params["layers"], l)
        h, k, v, _ = layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl)
        h = layer_mlp(lp, h, cfg, live=live)
        if want_caches:
            k_all[l] = k
            v_all[l] = v
    return h, k_all, v_all


def dense_prefill(params: dict, input_embeds, position_ids, cfg: LLMConfig, *,
                  attn_impl: str = "einsum", want_caches: bool = True):
    """Full dense prefill. Returns (logits_last (V,), k_all, v_all)."""
    cos, sin = token_cos_sin(pos_tokens(position_ids, input_embeds.device), cfg)
    h, k_all, v_all = run_layers(params, input_embeds, cos, sin, cfg, attn_impl=attn_impl,
                                 want_caches=want_caches)
    return final_logits(params, h[-1:], cfg)[0], k_all, v_all


def _pool_view(pool: torch.Tensor, l: int, s_view: int) -> torch.Tensor:
    """Layer ``l``'s cache restricted to its first ``s_view`` rows. Tail
    layers never hold more than the post-compression bucket, so reading only
    that prefix is identical (rows past a layer's length are masked either
    way) and skips the padded read of the full-prompt pool."""
    return pool[l, :s_view]


def _index_tensor(x, device) -> torch.Tensor:
    """Integer positions or lengths (tensor, array or nested list) as int64 on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.int64)


def _write_rows(pool: torch.Tensor, dim: int, rows: torch.Tensor, new: torch.Tensor, gate=None) -> None:
    """``pool.index_copy_(dim, rows, new)``: the device form's row write.
    Under a ``gate`` (a 0-d bool tensor) that is False the rows, clamped
    into the pool, are written back with what they hold, so nothing changes
    and nothing out of range is written (a captured macro step replayed
    after its decode ended)."""
    if gate is not None:
        rows = rows.clamp(max=pool.shape[dim] - 1)
        new = torch.where(gate, new, pool.index_select(dim, rows))
    pool.index_copy_(dim, rows, new)


def _check_impl(attn_impl: str, allowed) -> None:
    if attn_impl not in allowed:
        raise ValueError(f"attn_impl must be one of {allowed}, got {attn_impl!r}")


def _rows_qkv(layers: dict, lp: dict, x, l: int, cfg: LLMConfig, use_mv: bool):
    """q, k, v of the rows of ``x`` (R, D) at layer ``l``, each (R, H, hd);
    ``use_mv`` streams the projections from the stacks (kernel C)."""
    if not use_mv:
        return _project_qkv(lp, x, cfg)
    r, hd = x.shape[0], cfg.head_dim_
    q, k, v = mv_stacked_qkv(x, layers["wq"], layers["wk"], layers["wv"], l)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return (q.reshape(r, cfg.num_heads, hd), k.reshape(r, cfg.num_kv_heads, hd),
            v.reshape(r, cfg.num_kv_heads, hd))


def _rows_out_mlp(layers: dict, lp: dict, h, attn, l: int, cfg: LLMConfig, use_mv: bool):
    """``h + attn @ wo``, then the MLP block, for the rows of ``h`` (R, D);
    ``attn`` is (R, Hq * hd). ``use_mv`` streams every matvec (kernels C, D);
    a MoE stack takes ``moe_decode_mlp`` (its routed rows on C and D too)."""
    if use_mv:
        h = h + collectives.tensor_sum(mv_stacked(attn.to(h.dtype), layers["wo"], l))
        if cfg.is_moe:
            return moe_decode_mlp(lp, h, cfg, layers, l)
        x2 = rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
        gated = mv_stacked_gateup(x2, layers["w_gate"], layers["w_up"], l)
        return h + collectives.tensor_sum(mv_stacked(gated.to(h.dtype), layers["w_down"], l))
    h = h + collectives.tensor_sum(mm(attn.to(h.dtype), lp["wo"]))
    return moe_decode_mlp(lp, h, cfg) if cfg.is_moe else layer_mlp(lp, h, cfg)


def decode_step(params: dict, token_embed, position_id, k_pool, v_pool, cache_lens,
                cfg: LLMConfig, attn_impl: str = "einsum", tail_split=None):
    """One decode step against a padded per-layer cache pool.

    Args:
        token_embed: (D,) current-token embedding.
        position_id: rotary position: a host int, or an int64 scalar tensor
            on the pools' device.
        k_pool, v_pool: (L, S_pad, Hk, hd), updated IN PLACE (the JAX
            version returns new arrays; here the pools are owned by the
            decode loop, so an in-place row write saves a pool copy per step).
        cache_lens: per-layer valid entries excluding this token: host ints,
            or an int32/int64 (L,) tensor on the pools' device. With device
            tensors for both the step reads nothing back to the host (the
            row write is an indexed copy, the attention takes its length
            from the device), so it can be captured in a CUDA graph.
        attn_impl: one of ``DECODE_ATTN_IMPLS`` (module docstring).
        tail_split: optional ``(P, tail_s)`` — layers >= P attend only the
            pool's first ``tail_s`` rows.

    Returns:
        (logits (V,) fp32, k_pool, v_pool, cache_lens + 1): host ints, or an
        int64 (L,) tensor on the device.
    """
    _check_impl(attn_impl, DECODE_ATTN_IMPLS)
    on_device = isinstance(cache_lens, torch.Tensor)
    if isinstance(position_id, torch.Tensor):
        pos = position_id.reshape(1).to(torch.int64)
    else:
        pos = torch.tensor([position_id], device=token_embed.device)
    cos, sin = positions_cos_sin(pos, cfg)
    h = token_embed[None, :]
    use_mv = attn_impl != "einsum"
    attend = ragged_decode_attention if attn_impl == "ragged" else decode_attention
    layers = params["layers"]
    s_full = k_pool.shape[1]
    if tail_split is not None and tail_split[1] >= s_full:
        tail_split = None
    if on_device:
        lens = cache_lens.to(torch.int64)
        lens_after = lens + 1
    for l in range(cfg.num_layers):
        s_view = tail_split[1] if tail_split is not None and l >= tail_split[0] else s_full
        lp = layer_slice(layers, l)
        x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = _rows_qkv(layers, lp, x, l, cfg, use_mv)
        q, k = apply_rope(q, k, cos, sin)
        if on_device:
            k_pool[l].index_copy_(0, lens[l:l + 1], k.to(k_pool.dtype))
            v_pool[l].index_copy_(0, lens[l:l + 1], v.to(v_pool.dtype))
            length = lens_after[l]
        else:
            row = int(cache_lens[l])
            k_pool[l, row] = k[0].to(k_pool.dtype)
            v_pool[l, row] = v[0].to(v_pool.dtype)
            length = row + 1
        attn = attend(q[0], _pool_view(k_pool, l, s_view), _pool_view(v_pool, l, s_view), length)
        h = _rows_out_mlp(layers, lp, h, attn.reshape(1, -1), l, cfg, use_mv)
    logits = final_logits(params, h, cfg, use_mv)[0]
    new_lens = lens_after if on_device else [int(n) + 1 for n in cache_lens]
    return logits, k_pool, v_pool, new_lens


def verify_step(params: dict, token_embeds, position_ids, k_pool, v_pool, cache_lens, cfg: LLMConfig,
                attn_impl: str = "flash", tail_split=None, gate=None):
    """Speculative-verify step: K candidate rows through the stack together
    (one launch of kernels C and D each, which read each weight tile once
    for all K rows).

    Row 0 is the last committed token, rows 1..K-1 draft continuations. All
    K rows' K/V are written IN PLACE at each layer's own offset ``[len,
    len + K)`` (the caller rolls ``cache_lens`` forward by accepted + 1, so
    rejected rows are dead padding the next verify overwrites); row i
    attends the prefix plus rows 0..i (``verify_attention``).

    Args:
        token_embeds: (K, D). position_ids: (K,) rotary positions.
        k_pool, v_pool: (L, S_pad, Hk, hd), with >= K rows of headroom past
            every layer's length (inside ``tail_s`` for tail layers).
        cache_lens: per-layer valid entries excluding these rows: host
            ints, or an int (L,) tensor on the pools' device. With device
            tensors for it and ``position_ids`` the step reads nothing back
            to the host (the rows are written with ``index_copy_`` at
            ``lens[l] + arange(K)``, the mask is a tensor compare), so it can
            be captured in a CUDA graph; it computes what the host-int form
            computes, bit for bit.
        attn_impl: "flash" streams the projections through kernels C/D (the
            JAX package's default on the TPU); "einsum" is the plain path
            (JAX's ``FF_VERIFY_MV=0``).
        tail_split: optional ``(P, tail_s)`` as in :func:`decode_step`.
        gate: device form only: a 0-d bool tensor; when it is False the K
            rows are not written (``_write_rows``) and the logits mean
            nothing.

    Returns:
        (logits (K, V) fp32, k_pool, v_pool) — logits[i] scores the token
        after row i, as greedy decode would with rows 0..i committed.
    """
    _check_impl(attn_impl, ATTN_IMPLS)
    dev = token_embeds.device
    kq = token_embeds.shape[0]
    on_device = isinstance(cache_lens, torch.Tensor)
    if gate is not None and not on_device:
        raise ValueError("verify_step: a gate needs the device form (cache_lens a tensor)")
    cos, sin = positions_cos_sin(_index_tensor(position_ids, dev).reshape(kq), cfg)
    h = token_embeds
    use_mv = attn_impl == "flash"
    layers = params["layers"]
    s_full = k_pool.shape[1]
    if tail_split is not None and tail_split[1] >= s_full:
        tail_split = None
    if on_device:
        lens = cache_lens.to(torch.int64)
        rows = torch.arange(kq, device=dev)
    for l in range(cfg.num_layers):
        s_view = tail_split[1] if tail_split is not None and l >= tail_split[0] else s_full
        lp = layer_slice(layers, l)
        x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = _rows_qkv(layers, lp, x, l, cfg, use_mv)
        q, k = apply_rope(q, k, cos, sin)
        if on_device:
            length = lens[l]
            _write_rows(k_pool[l], 0, length + rows, k.to(k_pool.dtype), gate)
            _write_rows(v_pool[l], 0, length + rows, v.to(v_pool.dtype), gate)
        else:
            length = int(cache_lens[l])
            k_pool[l, length:length + kq] = k.to(k_pool.dtype)
            v_pool[l, length:length + kq] = v.to(v_pool.dtype)
        attn = verify_attention(q, _pool_view(k_pool, l, s_view), _pool_view(v_pool, l, s_view), length)
        h = _rows_out_mlp(layers, lp, h, attn.reshape(kq, -1), l, cfg, use_mv)
    return final_logits(params, h, cfg, use_mv), k_pool, v_pool


# Masked pool rows in the batched programs (the JAX package's value).
_BATCH_MASKED = -1e30


def _normalize_batch_split(tail_split, n_layers: int, s_pool: int):
    """A ``(P, tail_s, region_start)`` split that would not narrow the pool
    read (``tail_s >= region_start``) or leaves no layer on one side becomes
    None (``engine.best_tail_split_batch`` never emits one; this guards
    hand-built splits)."""
    if tail_split is None:
        return None
    p, tail_s, region_start = tail_split
    if region_start > s_pool:
        raise ValueError(f"tail_split {tail_split}: region start past the pool's {s_pool} rows")
    if not 0 < p < n_layers or tail_s >= region_start:
        return None
    return tail_split


def _attend_segments(qf, segments, s_cur, cur_pv, score_eq: str, pv_eq: str, scale: float):
    """fp32 softmax attention over masked pool segments plus the current rows.

    ``segments`` holds ``(k, v, mask)`` with k, v (B, S', Hk, hd) and mask
    (B, S') bool; ``s_cur`` are the current rows' scores (masked) and
    ``cur_pv(p_cur)`` their P.V term. One running max over every segment,
    sums and P.V terms added in segment order, then the current rows', as
    the JAX package's two- and three-way merges do."""
    scores = []
    for k_seg, _, mask in segments:
        sc = torch.einsum(score_eq, qf, k_seg.to(torch.float32)) * scale
        mask = mask.reshape(mask.shape[0], *([1] * (sc.ndim - 2)), mask.shape[-1])
        scores.append(sc.masked_fill(~mask, _BATCH_MASKED))
    m = s_cur.amax(dim=-1, keepdim=True)
    for sc in scores:
        m = torch.maximum(sc.amax(dim=-1, keepdim=True), m)
    denom, out = 0.0, 0.0
    for sc, (_, v_seg, _) in zip(scores, segments):
        p = torch.exp(sc - m)
        denom = denom + p.sum(dim=-1, keepdim=True)
        out = out + torch.einsum(pv_eq, p, v_seg.to(torch.float32))
    p_cur = torch.exp(s_cur - m)
    return (out + cur_pv(p_cur)) / (denom + p_cur.sum(dim=-1, keepdim=True))


def batch_decode_attention(q, k, v, k_pool, v_pool, l: int, prefix, in_decode, tail_split, scale: float):
    """Layer ``l``'s attention in :func:`decode_step_batch`: each row's query
    (q (B, Hq, hd)) over its pool prefix (``prefix`` (B, S_pool) bool) and
    the decode rows written so far (``in_decode`` (S_pool,) bool), plus the
    current token's own k, v (B, Hk, hd) as an extra column; the split's
    layers read two segments. Plain fp32 torch, as XLA computes it in JAX.
    Returns (B, Hk, G, hd) fp32."""
    b, hk, hd = k.shape
    qf = q.reshape(b, hk, -1, hd).to(torch.float32)
    vf_cur = v.to(torch.float32).reshape(b, hk, 1, hd)
    s_cur = (qf * k.to(torch.float32).reshape(b, hk, 1, hd)).sum(dim=-1, keepdim=True) * scale
    if tail_split is None or l < tail_split[0]:
        segments = [(k_pool[l], v_pool[l], prefix | in_decode[None, :])]
    else:
        tail_s, rs = tail_split[1], tail_split[2]
        segments = [(k_pool[l, :, :tail_s], v_pool[l, :, :tail_s], prefix[:, :tail_s]),
                    (k_pool[l, :, rs:], v_pool[l, :, rs:], in_decode[None, rs:].expand(b, -1))]
    return _attend_segments(qf, segments, s_cur, lambda p: p * vf_cur, "bhgd,bshd->bhgs", "bhgs,bshd->bhgd", scale)


def decode_step_batch(params: dict, token_embeds, position_ids, k_pool, v_pool, cache_lens, write_pos: int,
                      step: int, cfg: LLMConfig, attn_impl: str = "einsum", tail_split=None):
    """One decode step for a batch of sequences at a common write offset.

    Every (layer, sequence) writes its new K/V at ``write_pos + step`` (the
    JAX package's scatter-free layout); attention masks the two-interval
    valid set ``[0, cache_lens[l, b]) ∪ [write_pos, write_pos + step)`` and
    takes the current token as an extra column, so the pools are read-only
    through the layer loop and written once, IN PLACE, at the end.

    Args:
        token_embeds: (B, D). position_ids: (B,): host ints, or an int64
            tensor on the pools' device.
        k_pool, v_pool: (L, B, S_pool, Hk, hd). cache_lens: (L, B) prefix
            lengths (host ints or a tensor on the pools' device).
            write_pos: start of the decode region, a host int (the decode
            geometry). step: 0-based decode step: a host int, or an int64
            scalar tensor on the pools' device. With device tensors for
            ``step``, ``position_ids`` and ``cache_lens`` the step reads
            nothing back to the host (the decode mask is a tensor compare,
            the row write an indexed copy), so it can be captured in a CUDA
            graph; it computes what the host-int form computes, bit for bit.
        attn_impl: "einsum" (JAX "jax") or "flash" (the projections through
            kernels C/D for all B rows, which refuse B > 64 as JAX's
            do; JAX "pallas"). The attention is
            plain torch either way, as it is XLA in JAX.
        tail_split: optional ``(P, tail_s, region_start)`` — layers >= P
            read only rows ``[0, tail_s) ∪ [region_start, S_pool)``, merged
            with a 3-way online softmax; the caller guarantees those layers'
            prefixes stay below ``tail_s`` and ``tail_s <= region_start <=
            write_pos``.

    Returns:
        (logits (B, V) fp32, k_pool, v_pool).
    """
    _check_impl(attn_impl, ATTN_IMPLS)
    dev = token_embeds.device
    b = token_embeds.shape[0]
    n_l, s_pool = k_pool.shape[0], k_pool.shape[2]
    hk, hd = cfg.num_kv_heads, cfg.head_dim_
    write_pos = int(write_pos)
    if not isinstance(step, torch.Tensor):
        step = int(step)
    cos, sin = positions_cos_sin(_index_tensor(position_ids, dev).reshape(b), cfg)
    lens = _index_tensor(cache_lens, dev)
    pos_iota = torch.arange(s_pool, device=dev)
    in_decode = (pos_iota >= write_pos) & (pos_iota < write_pos + step)
    scale = 1.0 / math.sqrt(hd)
    use_mv = attn_impl == "flash"
    layers = params["layers"]
    tail_split = _normalize_batch_split(tail_split, n_l, s_pool)
    k_new = torch.empty((n_l, b, hk, hd), dtype=k_pool.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    h = token_embeds
    for l in range(n_l):
        lp = layer_slice(layers, l)
        x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = _rows_qkv(layers, lp, x, l, cfg, use_mv)
        q, k = apply_rope(q, k, cos, sin)
        prefix = pos_iota[None, :] < lens[l][:, None]  # (B, S_pool)
        out = batch_decode_attention(q, k, v, k_pool, v_pool, l, prefix, in_decode, tail_split, scale)
        h = _rows_out_mlp(layers, lp, h, out.reshape(b, -1), l, cfg, use_mv)
        k_new[l] = k.to(k_pool.dtype)
        v_new[l] = v.to(v_pool.dtype)
    row = torch.as_tensor(write_pos + step, device=dev).reshape(1)
    k_pool.index_copy_(2, row, k_new[:, :, None])
    v_pool.index_copy_(2, row, v_new[:, :, None])
    return final_logits(params, h, cfg, use_mv), k_pool, v_pool


def verify_step_batch(params: dict, token_embeds, position_ids, k_pool, v_pool, cache_lens, decode_mask,
                      write_pos, step, cfg: LLMConfig, attn_impl: str = "flash", tail_split=None,
                      k_tail=None, v_tail=None, phys=None, gate=None):
    """Speculative verify for a batch: (B, K) candidate rows together —
    :func:`verify_step` with :func:`decode_step_batch`'s cache layout.

    Each macro step writes every sequence's K rows at the common offset
    ``write_pos + step * K``, IN PLACE after the layer loop; ``decode_mask``
    marks only committed decode-region rows, so rows a sequence rejects stay
    invisible.

    Args:
        token_embeds: (B, K, D), row 0 each sequence's last committed token.
        position_ids: (B, K).
        k_pool, v_pool: (L, B, S_pool, Hk, hd). cache_lens: (L, B) prefix
            lengths. decode_mask: (B, S_pool) bool, committed decode rows.
        write_pos: start of the decode region. step: 0-based macro step.
            Each a host int, or an int64 scalar tensor on the pools' device:
            with either a tensor (and ``position_ids`` / ``cache_lens``
            tensors) the step reads nothing back to the host (the rows are
            written with ``index_copy_`` at ``write_pos + step * K +
            arange(K)``), so it can be captured in a CUDA graph; it computes
            what the host-int form computes, bit for bit.
        attn_impl: "flash" streams the projections through kernels C/D when
            B * K <= 64 rows; a MoE stack's rows, and an int8 head's, at any
            B * K, in blocks of 64 rows (the routed experts are never
            gathered); "einsum" is the plain path.
        tail_split: optional ``(P, tail_s, region_start)`` as in
            :func:`decode_step_batch`.
        k_tail, v_tail, phys: physically split tail pools ``(L - P, B,
            S_tail, Hk, hd)`` with ``phys = (P, tail_rs, rs)``: ``k_pool`` /
            ``v_pool`` hold only layers < P; tail rows ``[0, tail_rs)``
            mirror the prefix region and ``[tail_rs, S_tail)`` the decode
            region ``[rs, S_pool)``. ``decode_mask``, ``write_pos`` and
            ``step`` stay in head-pool coordinates. ``phys`` replaces
            ``tail_split``.
        gate: device form only: a 0-d bool tensor; when it is False no row
            is written (``_write_rows``) and the logits mean nothing.

    Returns:
        (logits (B, K, V) fp32, k_pool, v_pool, k_tail, v_tail).
    """
    _check_impl(attn_impl, ATTN_IMPLS)
    dev = token_embeds.device
    b, kq, _ = token_embeds.shape
    s_pool = k_pool.shape[2]
    hk, hd = cfg.num_kv_heads, cfg.head_dim_
    g = cfg.num_heads // hk
    n_l = cfg.num_layers
    cos, sin = positions_cos_sin(_index_tensor(position_ids, dev).reshape(b * kq), cfg)
    lens = _index_tensor(cache_lens, dev)
    decode_mask = decode_mask.to(dev)
    pos_iota = torch.arange(s_pool, device=dev)
    tril = torch.tril(torch.ones((kq, kq), dtype=torch.bool, device=dev))
    scale = 1.0 / math.sqrt(hd)
    use_mv = attn_impl == "flash" and (cfg.is_moe or b * kq <= matvec_q8.MAX_ROWS)
    block = matvec_q8.MAX_ROWS if use_mv else b * kq  # a MoE stack's rows past 64 go in blocks
    head_mv = attn_impl == "flash" and isinstance(params.get("lm_head"), dict)
    layers = params["layers"]
    on_device = isinstance(write_pos, torch.Tensor) or isinstance(step, torch.Tensor)
    if gate is not None and not on_device:
        raise ValueError("verify_step_batch: a gate needs the device form (write_pos or step a tensor)")
    if phys is not None:
        p_split, tail_rs, rs = phys
        if k_tail is None or k_pool.shape[0] != p_split or k_tail.shape[2] - tail_rs != s_pool - rs:
            raise ValueError(f"phys={phys}: head pool {tuple(k_pool.shape)} and tail pool "
                             f"{None if k_tail is None else tuple(k_tail.shape)} do not match")
    else:
        tail_split = _normalize_batch_split(tail_split, n_l, s_pool)
    k_new = torch.empty((n_l, b, kq, hk, hd), dtype=k_pool.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    h = token_embeds
    for l in range(n_l):
        if phys is not None and l >= p_split:
            k_l, v_l, seg = k_tail[l - p_split], v_tail[l - p_split], (tail_rs, tail_rs, rs)
        else:
            seg = None
            if tail_split is not None and l >= tail_split[0]:
                seg = (tail_split[1], tail_split[2], tail_split[2])
            k_l, v_l = k_pool[l], v_pool[l]
        lp = layer_slice(layers, l)
        x = rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = matvec_q8.by_row_blocks(lambda xb: _rows_qkv(layers, lp, xb, l, cfg, use_mv),
                                          x.reshape(b * kq, -1), block=block)
        q, k = apply_rope(q, k, cos, sin)
        k = k.reshape(b, kq, hk, hd)
        v = v.reshape(b, kq, hk, hd)
        qf = q.reshape(b, kq, hk, g, hd).to(torch.float32)
        vf_cur = v.to(torch.float32)
        s_cur = torch.einsum("bnhgd,bmhd->bhgnm", qf, k.to(torch.float32)) * scale
        s_cur = s_cur.masked_fill(~tril, _BATCH_MASKED)
        prefix = pos_iota[None, :] < lens[l][:, None]  # (B, S_pool)
        if seg is None:
            segments = [(k_l, v_l, prefix | decode_mask)]
        else:
            # Ragged prefix rows [0, tail_s) and the decode region from
            # pool_rs (this pool's coordinates; decode_mask's from mask_rs).
            tail_s, pool_rs, mask_rs = seg
            segments = [(k_l[:, :tail_s], v_l[:, :tail_s], prefix[:, :tail_s] | decode_mask[:, :tail_s]),
                        (k_l[:, pool_rs:], v_l[:, pool_rs:], decode_mask[:, mask_rs:])]
        out = _attend_segments(qf, segments, s_cur, lambda p: torch.einsum("bhgnm,bmhd->bhgnd", p, vf_cur),
                               "bnhgd,bshd->bhgns", "bhgns,bshd->bhgnd", scale)
        out = out.permute(0, 3, 1, 2, 4).reshape(b * kq, hk * g * hd)
        h = matvec_q8.by_row_blocks(lambda hb, ab: _rows_out_mlp(layers, lp, hb, ab, l, cfg, use_mv),
                                    h.reshape(b * kq, -1), out, block=block).reshape(b, kq, -1)
        k_new[l] = k.to(k_pool.dtype)
        v_new[l] = v.to(v_pool.dtype)
    if on_device:
        rows = write_pos + step * kq + torch.arange(kq, device=dev)

        def put(pool, new, shift=0):
            _write_rows(pool, 2, rows + shift, new, gate)
    else:
        base = int(write_pos) + int(step) * kq

        def put(pool, new, shift=0):
            pool[:, :, base + shift:base + shift + kq] = new
    if phys is not None:
        put(k_pool, k_new[:p_split])
        put(v_pool, v_new[:p_split])
        put(k_tail, k_new[p_split:], tail_rs - rs)
        put(v_tail, v_new[p_split:], tail_rs - rs)
    else:
        put(k_pool, k_new)
        put(v_pool, v_new)
    logits = matvec_q8.by_row_blocks(lambda hb: final_logits(params, hb, cfg, head_mv), h.reshape(b * kq, -1),
                                     block=matvec_q8.MAX_ROWS if head_mv else b * kq).reshape(b, kq, -1)
    return logits, k_pool, v_pool, k_tail, v_tail
