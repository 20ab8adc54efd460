"""Run-length token merging with static shapes.

Port of ``framefusion_tpu.core.merge``. A patch-major position is *marked*
when its similarity passes the gate; each run of consecutive marked
positions merges into the unmarked token just before it (the run head),
whose new value is the mean of itself and the run. Marked tokens are
dropped.

Both gates (threshold and budget) reduce to ``rank(sim) < k`` under a
stable descending sort, so ties go to the lowest patch-major index — the
policy the oracle and the JAX package pin. Run sums are differences of an
fp32 prefix sum: the formulation is deterministic on every device (an
``index_add_`` would sum in atomic order on CUDA, and the merged values feed
later decisions).
"""

from __future__ import annotations

import torch


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def descending_rank(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each element under a stable descending sort (0 = largest);
    ties rank lower indices first."""
    return inverse_permutation(torch.argsort(scores, descending=True, stable=True))


def mark_topk(sim: torch.Tensor, k) -> torch.Tensor:
    """Boolean mask of the ``k`` highest-similarity patch-major positions."""
    return descending_rank(sim) < k


def apply_merge(hidden: torch.Tensor, marked_pm: torch.Tensor, order: torch.Tensor):
    """Average marked tokens into their run heads.

    Args:
        hidden: (S, D) activations.
        marked_pm: (S,) bool in patch-major positions (position 0 unmarked).
        order: (S,) patch-major permutation.

    Returns:
        merged: (S, D) with run heads replaced by run means (hidden's dtype;
            fp32 accumulation).
        keep: (S,) bool in original positions; False for merged-away tokens.
    """
    s, d = hidden.shape
    dev = hidden.device
    pos = torch.arange(s, device=dev)
    inv_order = inverse_permutation(order)

    h_pm = hidden[order].to(torch.float32)
    contrib = torch.where(marked_pm[:, None], h_pm, torch.zeros((), device=dev))
    csum = torch.cumsum(contrib, dim=0)

    # Next unmarked position strictly after each position (reversed running
    # minimum): an unmarked head p absorbs the run (p, next_unmarked(p) - 1].
    unmarked_pos = torch.where(marked_pm, torch.full_like(pos, s), pos)
    nu_at_or_after = torch.flip(torch.cummin(torch.flip(unmarked_pos, [0]), dim=0).values, [0])
    nu_after = torch.cat([nu_at_or_after[1:], torch.full((1,), s, dtype=pos.dtype, device=dev)])
    run_end = torch.clamp(nu_after - 1, 0, s - 1)

    count = (run_end - pos).to(torch.float32)
    csum_pad = torch.cat([torch.zeros((1, d), dtype=torch.float32, device=dev), csum])
    seg_sum = csum_pad[run_end + 1] - csum_pad[pos + 1]

    merged_pm = (h_pm + seg_sum) / (1.0 + count)[:, None]
    merged_pm = torch.where(marked_pm[:, None], h_pm, merged_pm)

    merged = merged_pm[inv_order].to(hidden.dtype)
    keep = (~marked_pm)[inv_order]
    return merged, keep


def apply_merge_weighted(hidden: torch.Tensor, weights: torch.Tensor, marked_pm: torch.Tensor,
                         order: torch.Tensor):
    """Mass-weighted run merging (the merge->FastV baseline): each token
    carries the number of original tokens it stands for; a run head becomes
    the mass-weighted mean of itself and its run, and its mass the run's
    total.

    Args:
        hidden: (S, D); weights: (S,) fp32 per-token mass (original order);
            marked_pm, order: as ``apply_merge``.

    Returns:
        (merged, new_weights, keep), all in original order.
    """
    s, d = hidden.shape
    dev = hidden.device
    pos = torch.arange(s, device=dev)
    inv_order = inverse_permutation(order)

    h_pm = hidden[order].to(torch.float32)
    w_pm = weights[order].to(torch.float32)
    zero = torch.zeros((), device=dev)
    contrib = torch.where(marked_pm[:, None], h_pm * w_pm[:, None], zero)
    csum = torch.cumsum(contrib, dim=0)
    wcsum = torch.cumsum(torch.where(marked_pm, w_pm, zero), dim=0)

    unmarked_pos = torch.where(marked_pm, torch.full_like(pos, s), pos)
    nu_at_or_after = torch.flip(torch.cummin(torch.flip(unmarked_pos, [0]), dim=0).values, [0])
    nu_after = torch.cat([nu_at_or_after[1:], torch.full((1,), s, dtype=pos.dtype, device=dev)])
    run_end = torch.clamp(nu_after - 1, 0, s - 1)

    csum_pad = torch.cat([torch.zeros((1, d), dtype=torch.float32, device=dev), csum])
    wcsum_pad = torch.cat([torch.zeros((1,), dtype=torch.float32, device=dev), wcsum])
    seg_sum = csum_pad[run_end + 1] - csum_pad[pos + 1]
    seg_w = wcsum_pad[run_end + 1] - wcsum_pad[pos + 1]

    total_w = w_pm + seg_w
    merged_pm = (h_pm * w_pm[:, None] + seg_sum) / total_w[:, None]
    merged_pm = torch.where(marked_pm[:, None], h_pm, merged_pm)
    w_new_pm = torch.where(marked_pm, w_pm, total_w)

    merged = merged_pm[inv_order].to(hidden.dtype)
    return merged, w_new_pm[inv_order], (~marked_pm)[inv_order]
