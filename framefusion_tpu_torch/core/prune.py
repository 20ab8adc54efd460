"""Importance-based token pruning (port of ``framefusion_tpu.core.prune``).

Keep the top-k image tokens by the attention mass the last query row(s) pay
them, averaged over heads and rows; everything outside the image window
survives untouched. Ties follow ``descending_rank``'s stable policy.
"""

from __future__ import annotations

import torch

from .merge import descending_rank


def prune_keep_mask(importance: torch.Tensor, image_start, image_len, k_keep,
                    valid_mask: torch.Tensor) -> torch.Tensor:
    """Keep mask after importance pruning (original token order).

    Args:
        importance: (S,) fp32 attention mass per current token.
        image_start: first image-token position.
        image_len: current image-token count.
        k_keep: number of image tokens to keep.
        valid_mask: (S,) bool live (non-padding) tokens.
    """
    s = importance.shape[0]
    pos = torch.arange(s, device=importance.device)
    in_window = (pos >= image_start) & (pos < image_start + image_len) & valid_mask
    score = torch.where(in_window, importance, torch.full_like(importance, float("-inf")))
    keep_img = in_window & (descending_rank(score) < k_keep)
    return (valid_mask & ~in_window) | keep_img
