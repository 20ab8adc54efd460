"""GPipe pipeline parallelism over a ``stage`` mesh axis (port of
``framefusion_tpu.parallel.pipeline``).

Each rank of a ``(data, stage)`` mesh holds its stage's contiguous block of
``L / S`` layers and whole copies of the embedding, the final norm and the
head (``pipe_param_pspecs``, JAX's table). A batch is split into M
microbatches; ``data`` splits each microbatch's rows, as JAX composes data
parallelism on the microbatch axis.

The schedule is GPipe's fill-drain: every microbatch forward, stage by
stage (stage 0 embeds, each stage receives its input from the previous
stage and sends its output to the next, the last stage takes the loss),
then every microbatch backward in reverse order. JAX's backward falls out
of differentiating its ``scan`` + ``ppermute``; autograd does not cross a
send or a receive, so here the backward is an explicit schedule: a stage
receives the gradient of a microbatch's output from the next stage, runs
``torch.autograd.backward`` on that microbatch's stashed output (its layers
rematerialised, ``train.run_layers``) and sends the gradient of its input
to the previous stage. No bubble tick computes on zeros, as JAX's do; the
numbers are the same.

The replicated leaves (embedding, final norm, head) are one logical array
each: their gradients, the embedding's on stage 0 and the head's and the
norm's on the last stage, are summed over the stage group, so AdamW (whose
weight decay touches every leaf) steps every copy alike; then every
gradient is averaged over ``data``.
"""

from __future__ import annotations

import time

import torch

from ..config import LLMConfig
from ..models import qwen2
from . import collectives, train
from .sharding import mesh_device_type, pipe_param_pspecs, shard_axis, shard_params


def make_pipe_mesh(world: int | None = None, stages: int | None = None, data: int = 1):
    """A ``(data, stage)`` DeviceMesh over the process group's ranks
    (JAX's ``make_pipe_mesh``; ``stages`` defaults to the ranks over
    ``data``), of ``sharding.mesh_device_type()``'s device type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world is None else world
    stages = world // data if stages is None else stages
    if data * stages != world:
        raise ValueError(f"data={data} x stages={stages} is not the {world} ranks")
    return init_device_mesh(mesh_device_type(), (data, stages), mesh_dim_names=("data", "stage"))


def shard_params_pipe(params: dict, cfg: LLMConfig, mesh) -> dict:
    """This rank's stage of ``params`` (the whole model's tree): its block
    of layers and whole copies of the embedding, the final norm and the
    head (``sharding.shard_params`` over the ``stage`` axis)."""
    extra = sorted(set(params["layers"]) - set(pipe_param_pspecs(cfg)["layers"]))
    if extra:
        raise ValueError(f"the pipeline's table has no leaves {extra} (a dense stack only, as JAX's)")
    return shard_params(params, cfg, mesh)


class _Stage:
    """This rank's place on the mesh: its stage group and its data group."""

    def __init__(self, mesh):
        self.stage = collectives.Group(mesh.get_group("stage"))
        self.data = collectives.Group(mesh.get_group("data"))
        self.s, self.n = self.stage.rank, self.stage.size
        self.first, self.last = self.s == 0, self.s == self.n - 1
        self.wait_s = 0.0  # host seconds spent in receives

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        t0 = time.perf_counter()
        out = self.stage.recv(like, frm)
        self.wait_s += time.perf_counter() - t0
        return out


def microbatches(ids: torch.Tensor, n_micro: int, mesh) -> list:
    """The M microbatches of ``ids`` (B, T), each this rank's ``data``
    block of its rows. Raises where B does not split into M microbatches or
    a microbatch over the data ranks."""
    b = ids.shape[0]
    if b % n_micro:
        raise ValueError(f"a batch of {b} rows does not split into {n_micro} microbatches")
    mb, place = b // n_micro, shard_axis(mesh)
    return [place.rows(ids[m * mb:(m + 1) * mb]) for m in range(n_micro)]


def _forward(params: dict, mbs: list, cfg: LLMConfig, st: _Stage, grad: bool) -> list:
    """Every microbatch through this stage: ``(input, output)`` a
    microbatch; a later stage's input is received (a leaf that takes its
    gradient when ``grad``)."""
    t = mbs[0].shape[1]
    cos, sin = qwen2.positions_cos_sin(torch.arange(t, device=mbs[0].device), cfg)
    like = torch.empty((mbs[0].shape[0], t, cfg.hidden_size), dtype=params["embed"].dtype,
                       device=params["embed"].device)
    out = []
    for ids in mbs:
        if st.first:
            h_in = qwen2.embed(params, ids)
        else:
            h_in = st.recv(like, st.s - 1).requires_grad_(grad)
        h_out = train.run_layers(params["layers"], h_in, cos, sin, cfg)
        if not st.last:
            st.stage.send(h_out.detach(), st.s + 1)
        out.append((h_in, h_out))
    return out


def pipeline_forward(params: dict, ids: torch.Tensor, cfg: LLMConfig, mesh, n_micro: int) -> torch.Tensor:
    """(B, T) ids -> (B, T, V) fp32 logits on every rank (JAX's
    ``pipeline_forward``): the last stage's hidden states summed with the
    other stages' zeros over the stage group (JAX's psum-select), the head
    on every rank, the data ranks' rows gathered."""
    shard_axis(mesh).layers(cfg)
    st = _Stage(mesh)
    with torch.no_grad():
        mbs = microbatches(torch.as_tensor(ids).to(params["embed"].device, torch.int64), n_micro, mesh)
        h = torch.stack([h_out for _, h_out in _forward(params, mbs, cfg, st, grad=False)])
        h = st.stage.all_reduce(h if st.last else torch.zeros_like(h))
        logits = qwen2.head_logits(params, h, cfg)[..., :cfg.vocab_size]  # (M, B / M / D, T, V)
        logits = st.data.all_gather(logits[None], dim=0)  # (D, M, ...): each microbatch's rows by data rank
    return logits.transpose(0, 1).reshape(ids.shape[0], ids.shape[1], -1)


def make_pipe_train_step(cfg: LLMConfig, mesh, n_micro: int, optimizer=None, device=None):
    """Returns ``(train_step, init)`` (JAX's ``make_pipe_train_step``) over
    a ``(data, stage)`` mesh, on ``device`` (the card when None).

    ``init(params)`` takes this rank's stage (``shard_params_pipe`` or
    ``sharding.init_sharded_params(cfg, seed, mesh)``) and returns
    ``(params, opt_state)``. ``train_step(params, opt_state, ids)`` takes
    the global (B, T) batch on every rank, runs the GPipe schedule (module
    docstring) and one AdamW step, and returns ``(params, opt_state,
    loss)``: the global batch's mean loss on every rank. After a step
    ``train_step.stats`` holds this rank's host seconds of the step
    (``step_s``), of its forward and backward schedule (``schedule_s``,
    before the gradient reduces and the optimizer) and of its receives in
    that schedule (``wait_s``: the pipeline's bubble and the transfers)."""
    from ..weights import resolve_device

    device = resolve_device(device)
    optimizer = optimizer or train.make_optimizer()
    shard_axis(mesh).layers(cfg)
    st = _Stage(mesh)

    def init(params):
        params = train.trainable(params, device)
        return params, optimizer(train.leaves(params))

    def train_step(params, opt_state, ids):
        t0 = time.perf_counter()
        st.wait_s = 0.0
        mbs = microbatches(torch.as_tensor(ids).to(device=device, dtype=torch.int64), n_micro, mesh)
        opt_state.zero_grad(set_to_none=True)
        stash = _forward(params, mbs, cfg, st, grad=True)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for m in reversed(range(n_micro)):
            h_in, h_out = stash[m]
            if st.last:
                loss_m = train.lm_loss_from_hidden(params, h_out, mbs[m], cfg) / n_micro
                loss_m.backward()
                loss += loss_m.detach()
            else:
                h_out.backward(st.recv(h_out, st.s + 1))
            if not st.first:
                st.stage.send(h_in.grad, st.s - 1)
            stash[m] = None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        schedule_s = time.perf_counter() - t0
        shared = [params[k] for k in ("embed", "final_norm", "lm_head") if k in params]
        if st.n > 1:
            train.reduce_grads(st.stage, shared, mean=False)
            loss = st.stage.all_reduce(loss if st.last else torch.zeros_like(loss))
        if st.data.size > 1:
            train.reduce_grads(st.data, train.leaves(params), mean=True)
            loss = st.data.all_reduce(loss) / st.data.size
        opt_state.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_step.stats = {"step_s": time.perf_counter() - t0, "schedule_s": schedule_s, "wait_s": st.wait_s}
        return params, opt_state, loss

    train_step.stats = {}
    return train_step, init
