"""The collectives of a sharded model, scoped to the engine that owns them.

A rank of a tensor-parallel engine holds a slice of every sharded leaf
(``parallel/sharding.py``): a partial sum after each row-split product, a
slice of the vocabulary in the embedding and the head, a slice of the heads
in the prune's importance. The model functions (``models/qwen2.py``,
``models/moe.py``) call the helpers here at those places; each helper is the
identity unless a ``Scope`` is active, so a one-device model runs as before.

A ``Scope`` names a ``tensor`` group (heads, MLP inner width, vocabulary;
JAX's ``"tensor"`` mesh axis) and an ``expert`` group (the MoE expert axis;
the tensor group itself under tensor parallelism, as JAX's ``param_pspecs``
puts the expert axis in the tensor slot, or a group of its own under expert
parallelism, ``moe_pspecs``). The engine enters its scope around its own
calls (``use``); nothing is set for a whole process, so two engines, or two
tests in one process, never see each other's groups.

How a collective runs depends on the group's backend, chosen by the caller:

* NCCL: on the tensors in place, on the current stream, so a decode step
  that reduces is captured into its CUDA graph with the reduce inside it;
* gloo: gloo takes CPU tensors, so a CUDA tensor is staged through the host
  (copied to an fp32 CPU tensor, reduced, copied back). Such a collective
  cannot be captured; ``capturable()`` says so, and the decode graphs run
  their step eagerly under a gloo group (``runtime/decode_graph.py``).

Every rank of a group gets the same bits from a reduce (gloo and NCCL
reduce each element on one rank and send it on), so the host decisions that
read a replicated value (merge counts, keep counts) agree on every rank.
``record()`` counts the collectives run in a block and the host seconds
spent in them.

Training differentiates through the same helpers. Where the input needs a
gradient (and grad mode is on) each runs as an ``autograd.Function`` with
the backward a sharded model needs, Megatron's pairs:

* ``tensor_sum`` / ``embed_rows`` (a row-split product's partial sum, the
  masked lookup): the sum forward, the identity backward;
* ``tensor_input`` (the replicated input of column-split products: q / k /
  v, gate / up, a vocabulary-split head): the identity forward, the sum of
  the gradient over the group backward, since each rank's products give it
  only a partial gradient;
* ``vocab_gather``: the slices concatenated forward, this rank's slice of
  the gradient backward;
* ``expert_param`` (the router and the shared gate under tensor
  parallelism, whose uses on a rank cover only its own experts or its
  slice of the shared expert): the identity forward, the sum backward.

``Group.send`` / ``Group.recv`` move a pipeline stage's activations and
gradients; ``Group.all_reduce(op="max")`` is the vocabulary-split loss's
max.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass
class Record:
    """The collectives run while ``record()`` was active: their count (a
    collective recorded into a CUDA graph counts once, at the capture) and
    the host seconds spent in them."""

    calls: int = 0
    seconds: float = 0.0


_RECORDS: contextvars.ContextVar = contextvars.ContextVar("framefusion_records", default=())


@contextlib.contextmanager
def record():
    """Count the block's collectives, on any group, in the ``Record`` it
    yields (records nest: each active one counts)."""
    rec = Record()
    token = _RECORDS.set(_RECORDS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDS.reset(token)


def state():
    """The active scope and records, for ``carried`` on another thread."""
    return _SCOPE.get(), _RECORDS.get()


@contextlib.contextmanager
def carried(snapshot):
    """Run the block under a ``state()`` taken on another thread: autograd
    runs the backward of CUDA tensors (and the recomputation of a
    checkpointed layer) on its device thread, which sees none of the
    caller's context."""
    scope, records = snapshot
    t_scope, t_records = _SCOPE.set(scope), _RECORDS.set(records)
    try:
        yield
    finally:
        _RECORDS.reset(t_records)
        _SCOPE.reset(t_scope)


def _recorded(t0: float) -> None:
    seconds = time.perf_counter() - t0
    for rec in _RECORDS.get():
        rec.calls += 1
        rec.seconds += seconds


class Group:
    """A process group with its backend and this rank's place in it."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.ranks = dist.get_process_group_ranks(group) if group is not None else list(range(self.size))

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type != "cpu"

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or with ``op="max"`` the largest) of ``x`` over the
        group (a new tensor for a staged one, ``x`` reduced in place
        otherwise)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(x):
            host = x.to("cpu", torch.float32)
            dist.all_reduce(host, op=red, group=self.group)
            x = host.to(x.device, x.dtype)
        else:
            dist.all_reduce(x, op=red, group=self.group)
        _recorded(t0)
        return x

    def broadcast_first(self, x: torch.Tensor) -> torch.Tensor:
        """The group's first rank's ``x`` on every rank (a sum of it and
        zeros: the same bits)."""
        return self.all_reduce(x.clone() if self.rank == 0 else torch.zeros_like(x))

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Each rank's ``x`` concatenated along ``dim`` in group order."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        x = x.contiguous()
        if self.backend == "gloo":
            host = x.to("cpu") if x.device.type != "cpu" else x
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            out = torch.cat(parts, dim=dim).to(x.device)
        else:
            flat = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(flat, x, group=self.group)
            out = torch.cat(flat.unbind(0), dim=dim)
        _recorded(t0)
        return out

    def send(self, x: torch.Tensor, to: int) -> None:
        """Send ``x`` to the group's rank at place ``to`` (staged through the
        host in fp32 under gloo, as a reduce is)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        host = x.to("cpu", torch.float32) if self._staged(x) else x.contiguous()
        dist.send(host, self.ranks[to], group=self.group)
        _recorded(t0)

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device received from the
        group's rank at place ``frm``."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        staged = self._staged(like)
        buf = torch.empty(like.shape, dtype=torch.float32) if staged else torch.empty_like(like)
        dist.recv(buf, self.ranks[frm], group=self.group)
        out = buf.to(like.device, like.dtype) if staged else buf
        _recorded(t0)
        return out

    def rotate(self, tensors: list) -> list:
        """Send each tensor to the next rank of the group and receive the
        previous rank's (one ``batch_isend_irecv`` for all of them): a hop of
        a ring."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        staged = [self._staged(t) for t in tensors]
        send = [t.to("cpu") if s else t.contiguous() for t, s in zip(tensors, staged)]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, nxt, group=self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, prv, group=self.group) for t in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = [r.to(t.device) if s else r for r, t, s in zip(recv, tensors, staged)]
        _recorded(t0)
        return out


@dataclasses.dataclass(frozen=True)
class Scope:
    """The groups a sharded model reduces over. ``tensor``: the heads, the
    MLP inner width and the vocabulary are split over it. ``expert``: the
    MoE expert stacks are split over it; when it is ``tensor`` (tensor
    parallelism) the shared expert is split like a dense MLP, otherwise
    (expert parallelism) the shared expert and the attention are whole on
    every rank."""

    tensor: Optional[Group] = None
    expert: Optional[Group] = None

    def groups(self) -> list:
        return [g for g in {id(g): g for g in (self.tensor, self.expert) if g is not None}.values()]


_SCOPE: contextvars.ContextVar = contextvars.ContextVar("framefusion_scope", default=None)


@contextlib.contextmanager
def use(scope: Optional[Scope]):
    """Run the block under ``scope`` (None: no sharding)."""
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def current() -> Optional[Scope]:
    return _SCOPE.get()


def capturable() -> bool:
    """Whether the active scope's collectives can be captured in a CUDA
    graph: with no scope, or NCCL groups only."""
    scope = current()
    return scope is None or all(g.backend == "nccl" for g in scope.groups())


def _tensor() -> Optional[Group]:
    scope = current()
    return None if scope is None else scope.tensor


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """The sum over a group forward, the identity backward: every rank
    holds the same loss downstream of the sum, so each rank's partial input
    takes the sum's gradient as it is."""

    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGrad(torch.autograd.Function):
    """The identity forward, the sum of the gradient over a group backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.state = g, state()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with carried(ctx.state):
            return ctx.g.all_reduce(grad.clone()), None


class _Gather(torch.autograd.Function):
    """The ranks' slices concatenated along the last axis forward, this
    rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.n = g, x.shape[-1]
        return g.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.g.rank * ctx.n, ctx.n).contiguous(), None


def group_sum(g: Group, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``g``: ``g.all_reduce``, or under autograd the sum
    with the identity backward (``_Sum``)."""
    return _Sum.apply(x, g) if _differentiated(x) else g.all_reduce(x)


def tensor_sum(x: torch.Tensor) -> torch.Tensor:
    """A row-split product's partial sum, summed over the tensor group."""
    g = _tensor()
    return x if g is None else group_sum(g, x)


def tensor_input(x: torch.Tensor) -> torch.Tensor:
    """The replicated input of column-split products: itself forward; under
    autograd its gradient (each rank's partial one) summed over the tensor
    group backward."""
    g = _tensor()
    return _SumGrad.apply(x, g) if g is not None and _differentiated(x) else x


def tensor_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of ``x`` over the tensor group (no gradient)."""
    g = _tensor()
    return x if g is None else g.all_reduce(x.detach().clone(), op="max")


def tensor_rank() -> int:
    """This rank's place in the tensor group (0 without one): its slice of
    the vocabulary starts at that many slices."""
    g = _tensor()
    return 0 if g is None else g.rank


def expert_param(w: torch.Tensor) -> torch.Tensor:
    """A replicated leaf of the MoE block (the router, the shared gate)
    whose uses on a rank cover only that rank's experts or its slice of the
    shared expert: under tensor parallelism and autograd, its gradient is
    summed over the group; the leaf itself otherwise."""
    scope = current()
    if scope is None or not shared_expert_split() or not _differentiated(w):
        return w
    return _SumGrad.apply(w, scope.expert)


def tensor_mean(x: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's heads made the mean over all heads (every
    rank holds as many): the group's sum over its size."""
    g = _tensor()
    return x if g is None else g.all_reduce(x) / g.size


def vocab_gather(x: torch.Tensor) -> torch.Tensor:
    """A vocabulary slice of logits (..., V / n) gathered to (..., V)."""
    g = _tensor()
    if g is None:
        return x
    return _Gather.apply(x, g) if _differentiated(x) else g.all_gather(x, dim=-1)


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding ``table``: the whole table, or under a
    tensor group this rank's vocabulary rows, where ids outside the slice
    read zero and the group's sum gives each row once."""
    g = _tensor()
    n = table.shape[0]
    if g is None:
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)
    local = ids - g.rank * n
    inside = (local >= 0) & (local < n)
    # A 1-d index (a 0-d one would read it to the host): the lookup, and its
    # gradient's accumulation order, of the unsplit table's ``table[ids]``.
    rows = table[local.clamp(0, n - 1).reshape(-1)].reshape(*ids.shape, -1)
    return group_sum(g, rows * inside[..., None].to(table.dtype))


def expert_shard(num_experts: int):
    """``(group, first expert, experts a rank)`` of the active expert
    split, or None."""
    scope = current()
    if scope is None or scope.expert is None:
        return None
    g = scope.expert
    if num_experts % g.size:
        raise ValueError(f"{num_experts} experts do not split over {g.size} ranks")
    per = num_experts // g.size
    return g, g.rank * per, per


def shared_expert_split() -> bool:
    """Whether the shared expert is split over the expert group (tensor
    parallelism) rather than whole on every rank (expert parallelism)."""
    scope = current()
    return scope is not None and scope.expert is not None and scope.expert is scope.tensor
