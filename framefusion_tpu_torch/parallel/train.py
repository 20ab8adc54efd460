"""Training step (next-token LM loss, AdamW) over the Qwen2 stack, on one
device or across the ranks of a ``(data, tensor)`` mesh.

Port of ``framefusion_tpu.parallel.train``. The JAX step is one ``jit``
over a (data, tensor) mesh: the batch split over ``data``, the parameters
laid out by ``param_shardings`` (the optimizer state alike), GSPMD's
collectives in the forward and the backward pass. Here each rank runs the
same program on its shard (``parallel/sharding.shard_params`` or
``init_sharded_params``) with the collectives explicit:

* ``run_layers`` runs each decoder layer over the whole batch with the
  model's own ``qwen2.layer_attention`` and ``qwen2.layer_mlp``: the
  projections and the MLP as batched products, the attention core (RoPE and
  the plain fp32 ``"einsum"`` attention, as JAX's training step runs it)
  per sequence under ``torch.func.vmap``, which no collective enters; a MoE
  layer routes each sequence on its own (JAX's vmapped ``layer_mlp``: the
  capacity from T). The reduces sit between the products
  (``parallel/collectives``: a sum after ``wo`` / ``w_down`` with the
  identity backward, the sum of the gradient where the replicated input
  meets q / k / v and gate / up). Each layer is rematerialised in the
  backward pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` on the
  scanned layer); the recomputation re-enters the forward's collectives
  scope and records (``collectives.carried``), so every rank recomputes the
  same collectives in the same order (autograd runs the backward of CUDA
  tensors on its device thread, which does not see the caller's context).
* ``lm_loss`` takes the loss on each rank's vocabulary slice: the max, the
  sum of exponentials and the target's logit, each reduced over the tensor
  group, so no rank gathers (B, T, V) logits; a padded head's extra columns
  are masked.
* ``make_optimizer`` is ``torch.optim.AdamW`` set as optax's
  ``adamw(lr, weight_decay=0.01)``: betas (0.9, 0.999), eps 1e-8, every leaf
  decayed (norms and biases too). optax computes ``p - lr * (adam + wd * p)``
  and torch ``p * (1 - lr * wd) - lr * adam``: equal up to rounding. On the
  card it is torch's fused AdamW, which allocates no temporaries the size of
  the parameter list.
* ``make_train_step(cfg, device, mesh=mesh)`` takes the global batch, runs
  the rank's ``data`` slice (JAX's ``batch_shard``) and averages the
  gradients over ``data``: the loss is the global batch's mean. Each rank's
  AdamW state mirrors its shard, as JAX's optimizer state mirrors the
  parameter shardings.

Nothing in either package has a backward kernel, so autograd
differentiates plain PyTorch ops, as ``jax.value_and_grad`` differentiates
XLA ops. Neither package differentiates int8 weight pairs: the step
refuses them.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..models import qwen2
from ..weights import resolve_device
from . import collectives


def _scoped_layer(snapshot, layers: dict, l: int, h, cos, sin, cfg: LLMConfig):
    with collectives.carried(snapshot):
        lp = qwen2.layer_slice(layers, l)
        return qwen2.layer_mlp(lp, qwen2.layer_attention(lp, h, cos, sin, cfg)[0], cfg)


def run_layers(layers: dict, h: torch.Tensor, cos, sin, cfg: LLMConfig) -> torch.Tensor:
    """Every layer of the stacked ``layers`` (as many as its leaves hold: a
    pipeline stage's block, or the whole stack) over the batch ``h`` (B, T,
    D), each rematerialised in the backward pass under the active scope;
    ``cfg`` is the rank's local config. The layer's parameters are views of
    the stacked leaves, so their gradients land there."""
    snapshot = collectives.state()
    for l in range(layers["ln1"].shape[0]):
        h = checkpoint(_scoped_layer, snapshot, layers, l, h, cos, sin, cfg, use_reentrant=False)
    return h


def hidden(params: dict, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """(B, T) token ids -> (B, T, D) hidden states after the last layer."""
    t = ids.shape[1]
    cos, sin = qwen2.positions_cos_sin(torch.arange(t, device=ids.device), cfg)
    return run_layers(params["layers"], qwen2.embed(params, ids), cos, sin, cfg)


def forward_batched(params: dict, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """(B, T) token ids -> (B, T, V) fp32 logits (the vocabulary slices
    gathered under a tensor group)."""
    return qwen2.final_logits(params, hidden(params, ids, cfg), cfg)


def token_nll(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Each row's negative log-likelihood of its target from this rank's
    vocabulary slice ``logits`` (..., V / n) fp32: ``log sum exp - target
    logit`` with the max, the sum and the target's logit reduced over the
    tensor group. Columns past ``vocab_size`` (a padded head's) are masked.
    The max is a constant to autograd (its gradient cancels exactly)."""
    n = logits.shape[-1]
    lo = collectives.tensor_rank() * n
    if lo + n > vocab_size:
        cols = torch.arange(lo, lo + n, device=logits.device)
        logits = logits.masked_fill(cols >= vocab_size, float("-inf"))
    m = collectives.tensor_max(logits.detach().amax(dim=-1))
    sumexp = collectives.tensor_sum(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = targets - lo
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = collectives.tensor_sum(torch.where(inside, picked, torch.zeros_like(picked)))
    return torch.log(sumexp) + m - target


def lm_loss_from_hidden(params: dict, h: torch.Tensor, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Mean next-token NLL of ``ids`` (B, T) given the last layer's hidden
    states ``h`` (B, T, D) (fp32 scalar)."""
    return token_nll(qwen2.head_logits(params, h[:, :-1], cfg), ids[:, 1:], cfg.vocab_size).mean()


def lm_loss(params: dict, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``ids`` (fp32 scalar)."""
    return lm_loss_from_hidden(params, hidden(params, ids, cfg), ids, cfg)


def step_gemm_flops(cfg: LLMConfig, tokens: int) -> float:
    """The GEMM operations of one training step over ``tokens`` tokens: each
    layer's projections and MLP run forward, again in the recomputation and
    twice in the backward pass (4x the forward); the LM head, which is not
    rematerialised, forward and backward (3x). Attention and the embedding
    gather are not GEMMs and not counted."""
    d, hd = cfg.hidden_size, cfg.head_dim_
    per_layer = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + cfg.num_heads * hd * d + 3 * d * cfg.intermediate_size
    return 2 * tokens * (4 * cfg.num_layers * per_layer + 3 * d * cfg.vocab_size)


def _adamw(params: list, **kw) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, fused=params[0].is_cuda or None, **kw)


def make_optimizer(lr: float = 1e-4):
    """optax's ``adamw(lr, weight_decay=0.01)`` as a torch optimizer factory:
    call it with the parameter leaves (one group, every leaf decayed). Leaves
    on the card take torch's fused AdamW (module docstring)."""
    return functools.partial(_adamw, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def leaves(tree) -> list:
    """The tensors of a nested params dict, in a fixed (insertion) order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested params dict, the same nesting out."""
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def trainable(params: dict, device) -> dict:
    """The leaves on ``device`` as trainable tensors; refuses int8 pairs."""
    if any(isinstance(v, dict) for v in params["layers"].values()) or isinstance(params.get("lm_head"), dict):
        raise ValueError("cannot train int8 weight pairs: quantize after training")
    return tree_map(lambda t: t.detach().to(device).requires_grad_(True), params)


def reduce_grads(group: collectives.Group, tensors: list, mean: bool) -> None:
    """Each tensor's gradient summed (``mean``: averaged) over ``group``; a
    tensor with no gradient counts as zeros. Every rank gets the same bits."""
    for t in tensors:
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        g = group.all_reduce(g)
        t.grad = g.div_(group.size) if mean else g


def make_train_step(cfg: LLMConfig, device=None, optimizer=None, mesh=None):
    """Returns ``(train_step, init)`` on ``device`` (the card when None,
    which raises without one; ``"cpu"`` when asked).

    ``init(params)`` puts the leaves on the device as trainable tensors and
    builds the optimizer: returns ``(params, opt_state)``, ``opt_state``
    being the optimizer. ``train_step(params, opt_state, ids)`` takes one
    AdamW step on the batch and returns ``(params, opt_state, loss)``, the
    loss a device scalar (no read to the host); the leaves are updated in
    place and keep this step's gradients in ``.grad`` until the next step.

    ``mesh``: a ``(data, tensor)`` DeviceMesh (``sharding.make_mesh``), as
    JAX's ``make_train_step(cfg, mesh)``; ``cfg`` is then the whole model's
    and ``init`` takes this rank's shard. ``ids`` is the global (B, T)
    batch on every rank; the rank runs its ``data`` rows, the gradients are
    averaged over ``data`` and the loss returned is the global mean."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    local, scope, data, place = cfg, None, None, None
    if mesh is not None:
        from .sharding import local_config, mesh_scope, shard_axis

        place = shard_axis(mesh)
        if place.axis != "tensor":
            raise ValueError(f"the training step takes a (data, tensor) mesh, not a {place.axis} one")
        local, scope = local_config(cfg, place.width), mesh_scope(mesh)
        data = collectives.Group(mesh.get_group("data"))

    def init(params):
        params = trainable(params, device)
        return params, optimizer(leaves(params))

    def train_step(params, opt_state, ids):
        ids = torch.as_tensor(ids).to(device=device, dtype=torch.int64)
        if place is not None:
            ids = place.rows(ids)
        opt_state.zero_grad(set_to_none=True)
        with collectives.use(scope):
            loss = lm_loss(params, ids, local)
            loss.backward()
        loss = loss.detach()
        if data is not None and data.size > 1:
            reduce_grads(data, leaves(params), mean=True)
            loss = data.all_reduce(loss.clone()) / data.size
        opt_state.step()
        return params, opt_state, loss

    return train_step, init
