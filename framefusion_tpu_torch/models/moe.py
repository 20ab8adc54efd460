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

Expert parallelism (JAX's ``moe_pspecs``, ``make_expert_mesh``,
``shard_moe_params`` and ``sparse_mlp(ep=True)``): each rank of an expert
group holds E / n of the expert stacks; the router and the shared expert
are whole on every rank. Every rank routes every token over all E experts,
so the capacity, the rank-major slots and the tie-break are the one-device
decisions; each rank then computes only its own experts' slots, and the
combine is summed over the group (``parallel/collectives``). Under tensor
parallelism the expert axis rides the tensor group and the shared expert
is split like a dense MLP (``parallel/sharding.param_pspecs``).

Training differentiates ``sparse_mlp`` as it stands (the copies into the
buffer and the gathers out of it are permutations). Under tensor
parallelism a rank's routing weights cover only its own experts and its
shared-expert gate multiplies only its slice of the shared expert, so the
router's and the shared gate's gradients are partial on each rank: both are
read through ``collectives.expert_param``, which sums their gradients over
the group. ``load_balancing_loss`` is the Switch / GShard auxiliary loss of
the router's probs (JAX's; no loss of either package adds it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from ..parallel import collectives


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
    weights, slot, keep, c, probs = route(x, collectives.expert_param(mp["router"]), num_experts=num_experts,
                                          top_k=top_k,
                                          norm_topk_prob=norm_topk_prob, capacity=capacity, live=live)
    e = num_experts
    shard = collectives.expert_shard(num_experts)
    if shard is not None:  # this rank's experts [lo, lo + e): the others' choices go to the spare row
        _, lo, e = shard
        mine = keep & (slot >= lo * c) & (slot < (lo + e) * c)
        slot = torch.where(mine, slot - lo * c, torch.full_like(slot, e * c))
        weights = torch.where(mine, weights, torch.zeros_like(weights))
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
    return combine_shared(y, torch.sigmoid(x @ collectives.expert_param(mp["shared_gate"])) * shared), probs


def combine_shared(y: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
    """The routed experts' weighted sum ``y`` (any float dtype) plus the
    gated shared expert ``shared``, in ``shared``'s dtype. Under an expert
    split ``y`` holds this rank's experts only and is summed over the
    group (in fp32), with the shared expert's partial sum too where the
    shared expert is split (tensor parallelism)."""
    scope = collectives.current()
    if scope is None or scope.expert is None:
        return y.to(shared.dtype) + shared
    if collectives.shared_expert_split():
        return collectives.group_sum(scope.expert, y.to(torch.float32) + shared.to(torch.float32)).to(shared.dtype)
    return collectives.group_sum(scope.expert, y.to(torch.float32)).to(shared.dtype) + shared


def moe_prefill_capacity(s: int, cfg) -> int:
    """Per-expert budget of an S-row prefill call: ``S * top_k / E`` times
    ``moe_capacity_factor``, rounded up to a multiple of 8, at most S.

    Computed from the PHYSICAL row count of the call, as in JAX: each
    executor calls it with the row count JAX's counterpart holds there."""
    c = math.ceil(s * cfg.num_experts_per_tok / cfg.num_experts * cfg.moe_capacity_factor)
    return min(s, max(8, -(-c // 8) * 8))


def moe_mlp(mp: dict, x: torch.Tensor, cfg: MoeConfig, *, capacity: int | None = None, ep=None):
    """The block alone (``sparse_mlp`` with ``cfg``'s routing). ``ep``: an
    expert mesh (``make_expert_mesh``) whose rank holds ``mp``'s shard
    (``shard_moe_params``); JAX's ``ep=True`` under an active mesh."""
    run = functools.partial(sparse_mlp, mp, x, num_experts=cfg.num_experts, top_k=cfg.top_k,
                            norm_topk_prob=cfg.norm_topk_prob, capacity=capacity)
    if ep is None:
        return run()
    from ..parallel.sharding import mesh_scope

    with collectives.use(mesh_scope(ep)):
        return run()


def load_balancing_loss(probs: torch.Tensor, idx: torch.Tensor, cfg: MoeConfig) -> torch.Tensor:
    """The Switch / GShard auxiliary loss of one routed call (JAX's
    ``load_balancing_loss``, HF ``load_balancing_loss_func``): ``E *
    sum_e(fraction_e / top_k * mean_prob_e)`` over the router's probs (S,
    E) and its top-k choices ``idx`` (S, k); 1.0 for a balanced router."""
    oh = F.one_hot(idx.long(), cfg.num_experts).to(torch.float32)  # (S, k, E)
    tokens_per_expert = oh.sum(dim=1).mean(dim=0)  # (E,) in [0, k]
    router_prob = probs.to(torch.float32).mean(dim=0)
    return cfg.num_experts * (tokens_per_expert / cfg.top_k * router_prob).sum()


def moe_pspecs() -> dict:
    """JAX's ``moe_pspecs``: the expert stacks split over the ``expert``
    axis, the router and the shared expert whole (tuples of axis names, as
    ``parallel.sharding.param_pspecs``)."""
    rep2, rep3 = (None, None), ("expert", None, None)
    return {"router": rep2, "w_gate": rep3, "w_up": rep3, "w_down": rep3, "sw_gate": rep2, "sw_up": rep2,
            "sw_down": rep2, "shared_gate": rep2}


def make_expert_mesh(world: int | None = None, expert: int | None = None, data: int = 1):
    """A ``(data, expert)`` DeviceMesh over the process group's ranks
    (JAX's ``make_expert_mesh``: ``expert`` defaults to the ranks over
    ``data``), of ``parallel.sharding.mesh_device_type()``'s device type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..parallel.sharding import mesh_device_type

    world = dist.get_world_size() if world is None else world
    expert = world // data if expert is None else expert
    if data * expert != world:
        raise ValueError(f"data={data} x expert={expert} is not the {world} ranks")
    return init_device_mesh(mesh_device_type(), (data, expert), mesh_dim_names=("data", "expert"))


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's shard of a block's params (``init_moe_params``'s layout)
    over ``mesh``'s expert axis: the expert stacks' slice, the rest whole."""
    from ..parallel.sharding import shard_axis, shard_leaf

    ax, specs = shard_axis(mesh), moe_pspecs()
    return {k: shard_leaf(v, specs[k], ax.rank, ax.width, "expert") for k, v in params.items()}


def moe_layer(lp: dict, mp: dict, h: torch.Tensor, cos, sin, cfg, moe_cfg: MoeConfig, *,
              attn_impl: str = "einsum", capacity: int | None = None):
    """One Qwen2-MoE decoder layer: the attention block, then the sparse MLP
    in place of the dense one (pre-norm, residual). Returns (h, probs)."""
    from . import qwen2

    h, _, _, _ = qwen2.layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl)
    x = qwen2.rmsnorm(h, lp["ln2"], cfg.rms_norm_eps)
    y, probs = moe_mlp(mp, x, moe_cfg, capacity=capacity)
    return h + y, probs
