"""Qwen2-MoE sparse MLP block (port of ``framefusion_tpu.models.moe``).

HF ``Qwen2MoeSparseMoeBlock``: a softmax router picks the top-k experts of
each token (optionally renormalised), and a shared expert behind a sigmoid
gate is added. The prefill routes with the JAX package's GShard capacity
decisions, exactly:

* fp32 softmax, top-k, the optional renormalisation;
* rank-major priority: a token's rank-r choice claims its expert's next slot
  before any rank-(r + 1) choice (JAX's cumulative sum over the (k * S, E)
  one-hot choices taken rank by rank; here a stable sort of the k * S
  choices by expert, which gives the same positions);
* a choice keeps its slot when its position is below the capacity C; rows
  outside ``live`` make no choice at all.

JAX then moves the tokens with one-hot (S, E, C) dispatch and combine
tensors, which at the Qwen2-57B-A14B prefill (S 11,697, k 8, E 64, C 1,832)
would be tens of GB. Here the kept (token, rank) rows are copied into the
(E, C, D) buffer at their slots (``index_copy_``: a permutation, exact), the
experts run as products batched over E (``torch.bmm``; an int8 stack is
cast one layer at a time, as JAX's ``_expert_einsum`` does), and each
token's k outputs are gathered back and summed with its routing weights.

``record_drops`` collects, for each routed call, its physical row count,
its capacity and the (token, rank) choices it dropped (a device count,
read by the caller after the run).

Not ported here: ``moe_pspecs``, ``make_expert_mesh``, ``shard_moe_params``,
the ``ep=`` sharding flag and ``load_balancing_loss``; they belong to
expert parallelism and training (ROADMAP item "parallel/").
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    hidden_size: int
    moe_intermediate_size: int
    shared_expert_intermediate_size: int
    num_experts: int = 4
    top_k: int = 2
    norm_topk_prob: bool = False  # HF qwen2_moe default
    dtype: torch.dtype = torch.float32


def tiny_moe_config(**kw) -> MoeConfig:
    base = dict(hidden_size=64, moe_intermediate_size=96, shared_expert_intermediate_size=128,
                num_experts=4, top_k=2)
    base.update(kw)
    return MoeConfig(**base)


def init_moe_params(cfg: MoeConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal block weights (scale 0.02) drawn from ``generator`` in
    ``cfg.dtype``; the expert stacks lead with the expert axis."""
    device = torch.device(device) if device is not None else generator.device
    d, i, si, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size, cfg.num_experts

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(0.02)

    return {"router": norm(d, e), "w_gate": norm(e, d, i), "w_up": norm(e, d, i), "w_down": norm(e, i, d),
            "sw_gate": norm(d, si), "sw_up": norm(d, si), "sw_down": norm(si, d), "shared_gate": norm(d, 1)}


def expert_matmul(a: torch.Tensor, w) -> torch.Tensor:
    """a (..., M, in) @ w (..., in, out) over expert matrices, a dense stack
    or an int8 pair {"q8", "scale"} with scales (..., out); the q8 stack is
    cast to ``a``'s dtype for this call only (one layer's copy) and the
    per-channel scale applied after the contraction, as ``qwen2.mm`` does."""
    if isinstance(w, dict):
        y = torch.matmul(a, w["q8"].to(a.dtype)).to(torch.float32)
        return (y * w["scale"][..., None, :]).to(a.dtype)
    return torch.matmul(a, w)


def top_k_experts(x: torch.Tensor, router: torch.Tensor, top_k: int, norm_topk_prob: bool):
    """fp32 softmax over the experts, top-k, optional renormalisation (HF's
    order). Returns (weights (S, k) in x's dtype, idx (S, k), probs (S, E)).

    The top k come from a stable descending sort, so equal probabilities
    (common: the logits are rounded to x's dtype) rank the lower expert
    first, as ``jax.lax.top_k`` does and ``core.merge.descending_rank``
    pins; ``torch.topk`` keeps no such order. No host read: it runs inside
    the captured decode step."""
    probs = torch.softmax((x @ router).to(torch.float32), dim=-1)
    idx = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :top_k]
    weights = torch.gather(probs, -1, idx)
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights.to(x.dtype), idx, probs


def router_probs(mp: dict, x: torch.Tensor, cfg: MoeConfig):
    """``top_k_experts`` with the block's router and ``cfg``'s routing."""
    return top_k_experts(x, mp["router"], cfg.top_k, cfg.norm_topk_prob)


_DROPS: list | None = None


@contextlib.contextmanager
def record_drops():
    """Within the block, each routed ``sparse_mlp`` call appends ``(rows,
    capacity, dropped)`` to the list it yields: its physical row count, its
    capacity C and the number of (token, rank) choices that found their
    expert full (a 0-d device tensor: read it after the run)."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def route(x: torch.Tensor, router: torch.Tensor, *, num_experts: int, top_k: int, norm_topk_prob: bool,
          capacity: int | None = None, live: torch.Tensor | None = None):
    """The GShard capacity decisions of JAX's ``sparse_mlp``.

    Returns (weights (S, k) in x's dtype, zero where a choice was not kept;
    slot (S, k) int64, ``expert * C + position`` of each kept choice and ``E
    * C`` (one spare row) for the others; keep (S, k) bool; C; probs)."""
    s = x.shape[0]
    e, k = num_experts, top_k
    c = s if capacity is None else min(capacity, s)
    weights, idx, probs = top_k_experts(x, router, k, norm_topk_prob)
    # Rank-major: the (k, S) choices in that order, each one's position in
    # its expert the count of earlier choices of the same expert (JAX's
    # cumulative sum over the one-hot choices). A stable sort by expert keeps
    # that order within each expert, so a choice's position is its place in
    # the sorted order less its expert's start; dead rows' choices go to a
    # spare expert E and claim nothing.
    flat = idx.transpose(0, 1).reshape(-1)
    if live is not None:
        flat = torch.where(live.repeat(k), flat, torch.full_like(flat, e))
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(e + 1, dtype=torch.int64, device=x.device).scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat).scatter_(0, order, torch.arange(k * s, device=x.device) - starts[flat[order]])
    pos, chosen = pos.reshape(k, s).transpose(0, 1), (flat != e).reshape(k, s).transpose(0, 1)
    keep = chosen & (pos < c)
    slot = torch.where(keep, idx * c + pos, torch.full_like(idx, e * c))
    if _DROPS is not None:
        _DROPS.append((s, c, (chosen & ~keep).sum()))
    return torch.where(keep, weights, torch.zeros_like(weights)), slot, keep, c, probs


def sparse_mlp(mp: dict, x: torch.Tensor, *, num_experts: int, top_k: int, norm_topk_prob: bool,
               capacity: int | None = None, live: torch.Tensor | None = None):
    """(S, D) -> (S, D) sparse MLP and the router probs (JAX's ``sparse_mlp``).

    ``capacity`` is the per-expert budget C (None: lossless, C = S, HF's
    semantics); ``live`` (bool (S,)) keeps dead rows out of the routing, so
    a mask-only executor routes its live tokens as a compacted one does.
    ``mp`` holds router / w_gate / w_up / w_down (expert axis first) /
    sw_* / shared_gate, dense or int8 pairs (not the router or the gate)."""
    s, d = x.shape
    weights, slot, _, c, probs = route(x, mp["router"], num_experts=num_experts, top_k=top_k,
                                       norm_topk_prob=norm_topk_prob, capacity=capacity, live=live)
    e = num_experts
    xe = x.new_zeros((e * c + 1, d))  # the last row takes every dropped choice and is never read
    tokens = torch.arange(s, device=x.device)[:, None].expand(s, top_k)
    xe.index_copy_(0, slot.reshape(-1), x[tokens.reshape(-1)])
    xe = xe[:-1].reshape(e, c, d)
    gated = F.silu(expert_matmul(xe, mp["w_gate"])) * expert_matmul(xe, mp["w_up"])
    del xe
    ye = expert_matmul(gated, mp["w_down"]).reshape(e * c, d)
    del gated
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    y = torch.zeros((s, d), dtype=torch.float32, device=x.device)
    for r in range(top_k):  # rank by rank: an (S, D) gather at a time
        y += ye[slot[:, r]].to(torch.float32) * weights[:, r, None].to(torch.float32)
    del ye
    from .qwen2 import mm

    shared = mm(F.silu(mm(x, mp["sw_gate"])) * mm(x, mp["sw_up"]), mp["sw_down"])
    return y.to(x.dtype) + torch.sigmoid(x @ mp["shared_gate"]) * shared, probs


def moe_prefill_capacity(s: int, cfg) -> int:
    """Per-expert budget of an S-row prefill call: ``S * top_k / E`` times
    ``moe_capacity_factor``, rounded up to a multiple of 8, at most S.

    Computed from the PHYSICAL row count of the call, as in JAX: each
    executor calls it with the row count JAX's counterpart holds there."""
    c = math.ceil(s * cfg.num_experts_per_tok / cfg.num_experts * cfg.moe_capacity_factor)
    return min(s, max(8, -(-c // 8) * 8))


def moe_mlp(mp: dict, x: torch.Tensor, cfg: MoeConfig, *, capacity: int | None = None):
    """The block alone (``sparse_mlp`` with ``cfg``'s routing)."""
    return sparse_mlp(mp, x, num_experts=cfg.num_experts, top_k=cfg.top_k, norm_topk_prob=cfg.norm_topk_prob,
                      capacity=capacity)


def moe_layer(lp: dict, mp: dict, h: torch.Tensor, cos, sin, cfg, moe_cfg: MoeConfig, *,
              attn_impl: str = "einsum", capacity: int | None = None):
    """One Qwen2-MoE decoder layer: the attention block, then the sparse MLP
    in place of the dense one (pre-norm, residual). Returns (h, probs)."""
    from . import qwen2

    h, _, _, _ = qwen2.layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl)
    x = qwen2.rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
    y, probs = moe_mlp(mp, x, moe_cfg, capacity=capacity)
    return h + y, probs
