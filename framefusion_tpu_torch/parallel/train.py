"""One-card training step (next-token LM loss, AdamW) over the Qwen2 stack.

Port of ``framefusion_tpu.parallel.train``. The JAX step is one ``jit``
over a (data, tensor) mesh; here it runs on one device:

* ``forward_batched`` embeds, runs each layer over every sequence with
  ``torch.func.vmap`` (JAX's ``jax.vmap(single)``) and rematerialises each
  layer in the backward pass (``torch.utils.checkpoint``, JAX's
  ``jax.checkpoint`` on the scanned layer). Attention is the plain fp32
  ``"einsum"`` path, as JAX's training step runs it: nothing in either
  package has a backward kernel, so autograd differentiates plain PyTorch
  ops, as ``jax.value_and_grad`` differentiates XLA ops.
* ``make_optimizer`` is ``torch.optim.AdamW`` set as optax's
  ``adamw(lr, weight_decay=0.01)``: betas (0.9, 0.999), eps 1e-8, every leaf
  decayed (norms and biases too). optax computes ``p - lr * (adam + wd * p)``
  and torch ``p * (1 - lr * wd) - lr * adam``: equal up to rounding.

The JAX step's mesh (batch over ``data``, heads and MLP over ``tensor``)
and the Qwen2-MoE training side (the router's load-balancing loss) wait for
the port's multi-card ``parallel/``; this step refuses MoE configs and int8
weight pairs, which neither package differentiates.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LLMConfig
from ..models import qwen2
from ..weights import resolve_device


def forward_batched(params: dict, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """(B, T) token ids -> (B, T, V) fp32 logits. Each layer runs per
    sequence under ``vmap``; the layer's parameters are views of the stacked
    ``(L, ...)`` leaves, so their gradients land there."""
    t = ids.shape[1]
    h = qwen2.embed(params, ids)
    cos, sin = qwen2.positions_cos_sin(torch.arange(t, device=ids.device), cfg)

    def one_layer(h, l: int):
        lp = qwen2.layer_slice(params["layers"], l)

        def single(hs):
            hs, _, _, _ = qwen2.layer_attention(lp, hs, cos, sin, cfg, attn_impl="einsum")
            return qwen2.layer_mlp(lp, hs, cfg)

        return torch.func.vmap(single)(h)

    for l in range(cfg.num_layers):
        h = checkpoint(one_layer, h, l, use_reentrant=False)
    return qwen2.final_logits(params, h, cfg)


def lm_loss(params: dict, ids: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``ids`` (fp32 scalar)."""
    logits = forward_batched(params, ids, cfg)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
    return nll.mean()


def step_gemm_flops(cfg: LLMConfig, tokens: int) -> float:
    """The GEMM operations of one training step over ``tokens`` tokens: each
    layer's projections and MLP run forward, again in the recomputation and
    twice in the backward pass (4x the forward); the LM head, which is not
    rematerialised, forward and backward (3x). Attention and the embedding
    gather are not GEMMs and not counted."""
    d, hd = cfg.hidden_size, cfg.head_dim_
    per_layer = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + cfg.num_heads * hd * d + 3 * d * cfg.intermediate_size
    return 2 * tokens * (4 * cfg.num_layers * per_layer + 3 * d * cfg.vocab_size)


def make_optimizer(lr: float = 1e-4):
    """optax's ``adamw(lr, weight_decay=0.01)`` as a torch optimizer factory:
    call it with the parameter leaves (one group, every leaf decayed)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


def leaves(tree) -> list:
    """The tensors of a nested params dict, in a fixed (insertion) order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested params dict, the same nesting out."""
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def make_train_step(cfg: LLMConfig, device=None, optimizer=None):
    """Returns ``(train_step, init)`` on ``device`` (the card when None,
    which raises without one; ``"cpu"`` when asked).

    ``init(params)`` puts the leaves on the device as trainable tensors and
    builds the optimizer: returns ``(params, opt_state)``, ``opt_state``
    being the optimizer. ``train_step(params, opt_state, ids)`` takes one
    AdamW step on the batch and returns ``(params, opt_state, loss)``, the
    loss a device scalar (no read to the host); the leaves are updated in
    place and keep this step's gradients in ``.grad`` until the next step.

    One device only: the JAX step's mesh and batch sharding wait for the
    multi-card ``parallel/``.
    """
    if cfg.is_moe:
        raise NotImplementedError("training a Qwen2-MoE stack (its load-balancing loss, expert parallelism) "
                                  "is not ported yet")
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()

    def init(params):
        if any(isinstance(v, dict) for v in params["layers"].values()) or isinstance(params.get("lm_head"), dict):
            raise ValueError("cannot train int8 weight pairs: quantize after training")
        params = tree_map(lambda t: t.detach().to(device).requires_grad_(True), params)
        return params, optimizer(leaves(params))

    def train_step(params, opt_state, ids):
        ids = torch.as_tensor(ids).to(device=device, dtype=torch.int64)
        opt_state.zero_grad(set_to_none=True)
        loss = lm_loss(params, ids, cfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step, init
