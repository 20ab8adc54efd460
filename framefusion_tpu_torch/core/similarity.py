"""Adjacent-frame patchwise cosine similarity.

Port of ``framefusion_tpu.core.similarity``. In patch-major order, position
``i`` scores the cosine similarity between the tokens at positions ``i-1``
and ``i`` — the same spatial patch in consecutive frames. The first
position, patch boundaries and every position at or past ``n_img`` carry the
IGNORE sentinel (-2), which no threshold in (0, 1] can pass. Accumulation is
fp32 whatever the activation dtype.
"""

from __future__ import annotations

import torch

from .constants import IGNORE_TOKEN


def similarity_by_patch(hidden: torch.Tensor, patch_type: torch.Tensor, order: torch.Tensor,
                        n_img: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of consecutive same-patch tokens, patch-major.

    Args:
        hidden: (S, D) activations.
        patch_type: (S,) patch ids / sentinels (original order).
        order: (S,) patch-major permutation from ``order_by_patch``.
        n_img: scalar count of image tokens.

    Returns:
        (S,) fp32 similarity per patch-major position.
    """
    s = hidden.shape[0]
    h = hidden[order].to(torch.float32)
    pt = patch_type[order]
    prev, cur = h[:-1], h[1:]
    dot = (prev * cur).sum(dim=-1)
    norm = torch.linalg.vector_norm(prev, dim=-1) * torch.linalg.vector_norm(cur, dim=-1)
    ignore = torch.full((1,), float(IGNORE_TOKEN), dtype=torch.float32, device=hidden.device)
    sim = torch.cat([ignore, dot / norm])
    pos = torch.arange(s, device=hidden.device)
    same_patch = torch.cat([torch.zeros(1, dtype=torch.bool, device=hidden.device), pt[1:] == pt[:-1]])
    in_range = (pos >= 1) & (pos < n_img)
    return torch.where(in_range & same_patch, sim, ignore)
