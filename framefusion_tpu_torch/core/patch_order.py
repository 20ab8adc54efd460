"""Patch-major reordering of the token sequence.

Port of ``framefusion_tpu.core.patch_order``: all tokens of patch 0 in
sequence order, then all tokens of patch 1, and so on; consecutive entries
within a patch are the same spatial position in consecutive frames — the
merge candidates. A composite key and a sort keep the shape static: image
tokens sort to the front in (patch, position) order, every other token to the
back in position order.
"""

from __future__ import annotations

import torch


def order_by_patch(patch_type: torch.Tensor, valid_mask: torch.Tensor, patch_num: int):
    """Compute the patch-major token permutation.

    Args:
        patch_type: (S,) int patch ids / negative sentinels.
        valid_mask: (S,) bool, False for dead or padding slots.
        patch_num: spatial patches per frame.

    Returns:
        order: (S,) int64 permutation — original index of the token at each
            patch-major position; positions ``>= n_img`` hold the rest.
        n_img: scalar int64 tensor, the number of valid image tokens.
    """
    s = patch_type.shape[0]
    idx = torch.arange(s, dtype=torch.int64, device=patch_type.device)
    pt = patch_type.to(torch.int64)
    is_img = (pt >= 0) & (pt < patch_num) & valid_mask
    key = torch.where(is_img, pt * s + idx, patch_num * s + idx)
    order = torch.argsort(key, stable=True)
    return order, is_img.sum()
