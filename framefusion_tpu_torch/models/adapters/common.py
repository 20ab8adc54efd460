"""Adapter layer: prompt metadata -> ``PrefillInputs`` (port of
``framefusion_tpu.models.adapters.common``).

``patch_type`` semantics: -1 text, >= 0 the spatial patch id within a frame;
consecutive frames repeat the same id range, so same-id neighbours in
patch-major order are adjacent-frame merge candidates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.constants import TEXT_TOKEN


@dataclasses.dataclass
class PrefillInputs:
    """Everything the compression engine needs for one prefill."""

    input_embeds: object  # (S, D) numpy array or tensor
    patch_type: np.ndarray  # (S,) int
    position_ids: np.ndarray  # (S,) int
    patch_num: int
    image_token_start: int
    image_token_length: int
    num_importance_queries: int = 1


def contiguous_patch_type(total_len: int, start: int, patch_num: int, n_frames: int) -> np.ndarray:
    """[TEXT]*start + (0..patch_num-1)*n_frames + [TEXT]*rest."""
    pt = np.full(total_len, TEXT_TOKEN, dtype=np.int32)
    pt[start : start + patch_num * n_frames] = np.tile(np.arange(patch_num, dtype=np.int32), n_frames)
    return pt


def build_video_prompt(rng: np.random.Generator, hidden: int, n_frames: int = 64, patch_num: int = 182,
                       n_pre: int = 35, n_post: int = 14, coherent: float = 0.45):
    """Synthetic LLaVA-Video-style prompt (numpy copy of ``bench.build_video_prompt``).

    patch_num=182 is LLaVA-Video-7B's 13x14 patch grid per frame; at 64
    frames the prompt is 11,697 tokens. ``coherent`` is the fraction of
    adjacent-frame patch pairs that resemble each other, with perturbation
    scales that spread similarities over (0.6, 1.0) like real video.

    Returns (embeds (S, hidden) fp32, patch_type (S,) int32, image start, image length).
    """
    n_img = patch_num * n_frames
    s = n_pre + n_img + n_post
    patch_type = contiguous_patch_type(s, n_pre, patch_num, n_frames)
    h = rng.standard_normal((s, hidden)).astype(np.float32) * 0.05
    for f in range(1, n_frames):
        cur = slice(n_pre + f * patch_num, n_pre + (f + 1) * patch_num)
        prev = slice(n_pre + (f - 1) * patch_num, n_pre + f * patch_num)
        mask = rng.random(patch_num) < coherent
        scale = rng.uniform(0.05, 0.5, size=(patch_num, 1)).astype(np.float32)
        blended = h[prev] + scale * rng.standard_normal((patch_num, hidden)).astype(np.float32) * 0.05
        h[cur] = np.where(mask[:, None], blended, h[cur])
    return h, patch_type, n_pre, n_img
