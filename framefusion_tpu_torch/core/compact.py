"""Mask-and-compact repacking to bucketed lengths.

Port of ``framefusion_tpu.core.compact``. The keep mask becomes a stable
partition: survivors are packed to the front in their original order and the
arrays are sliced to a bucketed length. Slots past the survivor count are
padding, marked dead by the validity mask and the PAD patch-type sentinel.
"""

from __future__ import annotations

import torch

from .constants import PAD_TOKEN

BUCKET = 128


def bucket_length(n: int, bucket: int = BUCKET) -> int:
    """Smallest multiple of ``bucket`` that holds ``n`` tokens."""
    return max(bucket, -(-n // bucket) * bucket)


def compaction_order(keep: torch.Tensor) -> torch.Tensor:
    """Permutation packing kept tokens first, original order preserved."""
    return torch.argsort((~keep).to(torch.uint8), stable=True)


def compact_tokens(keep: torch.Tensor, new_len: int, new_valid: int, arrays: dict):
    """Pack survivors to the front and slice to ``new_len``.

    Args:
        keep: (S,) bool keep mask (padding slots already False).
        new_len: bucketed output length (<= S).
        new_valid: true survivor count (<= new_len).
        arrays: name -> tensor whose leading axis is the token axis;
            ``patch_type`` also gets the PAD sentinel in the padding region.

    Returns:
        (out_arrays, valid_mask) of leading length ``new_len``.
    """
    order = compaction_order(keep)[:new_len]
    valid = torch.arange(new_len, device=keep.device) < new_valid
    out = {}
    for name, arr in arrays.items():
        packed = arr[order]
        if name == "patch_type":
            packed = torch.where(valid, packed, torch.full_like(packed, PAD_TOKEN))
        out[name] = packed
    return out, valid
