"""FLOP-budget scheduler for progressive token compression.

Port of ``framefusion_tpu.core.schedule``. Each compression event ``i``
multiplies the live-token density by ``(1 - sparsity_i)``; the cost model is
the sum over layers of the density at that layer, normalised so the dense
model costs ``num_layers``. Given the sparsities so far, this returns the
sparsity the next event must apply for the total to land on
``num_layers * cost``.

Two twins with the same float32 operation order (a design invariant: the
decisions of every executor must agree bit for bit):
  * ``compute_pruning_ratio`` — host numpy fp32, used by the engine.
  * ``compute_pruning_ratio_device`` — torch fp32 on the tensors' device.
PyTorch runs each elementwise op as its own kernel, so the device twin does
exactly the host twin's roundings.
"""

from __future__ import annotations

import numpy as np
import torch


class CostInfeasibleError(ValueError):
    """The requested cost cannot be reached given compression so far."""


def compute_pruning_ratio(sparsity_list: list[float], cost: float, num_layers: int = 28) -> float:
    """Sparsity required at the next compression event to hit ``cost``.

    Returns a value in ``[0, 1]``; ``0`` means no compression is needed.

    Raises:
        CostInfeasibleError: if even pruning everything cannot reach ``cost``.
    """
    f = np.float32
    n_events = len(sparsity_list)
    density = f(1.0)
    spent = f(0.0)
    for s in sparsity_list:
        density = f(density * (f(1.0) - f(s)))
        spent = f(spent + density)
    remaining_budget = f(f(num_layers) * f(cost) - spent)
    if remaining_budget < 0:
        raise CostInfeasibleError("The cost is too small")
    remaining_layers = f(num_layers - n_events)
    frac = f(remaining_budget / f(remaining_layers * density))
    if frac > 1:
        return 0.0
    return float(f(f(1.0) - frac))


def compute_pruning_ratio_device(sparsity: torch.Tensor, n_events: torch.Tensor, cost: torch.Tensor,
                                 num_layers: int):
    """Tensor twin of ``compute_pruning_ratio``.

    Args:
        sparsity: (max_events,) fp32 recorded per-event sparsities.
        n_events: scalar int tensor, how many entries are valid.
        cost: scalar fp32 tensor.

    Returns:
        (ratio, infeasible): fp32 scalar in [0, 1] and a bool scalar in place
        of the host twin's exception.
    """
    one = torch.ones((), dtype=torch.float32, device=sparsity.device)
    density = one.clone()
    spent = torch.zeros((), dtype=torch.float32, device=sparsity.device)
    for i in range(sparsity.shape[0]):
        active = i < n_events
        new_density = torch.where(active, density * (one - sparsity[i]), density)
        spent = torch.where(active, spent + new_density, spent)
        density = new_density
    remaining = torch.tensor(float(num_layers), dtype=torch.float32, device=sparsity.device) * cost - spent
    infeasible = remaining < 0
    # Same operation order as the host twin: multiply the denominator first.
    frac = remaining / ((float(num_layers) - n_events.to(torch.float32)) * density)
    ratio = torch.where(frac > 1, torch.zeros_like(frac), one - frac)
    return ratio, infeasible
