"""LLaVA-NeXT-Video adapter (port of
``framefusion_tpu.models.adapters.llava_next_video``).

The reference's hook (models/llava_next_video/modeling_llava_next_video.py:
226-234) stores a per-token frame index and never enables compression; the
JAX package completes it the way the other families work: spatial patch ids
a frame, ``token_per_frame = vit_patches / pool_kernel^2``. The reference's
frame index is ``frame_index_token_type``.

Pure numpy on the mask: the embeddings pass through as given.
"""

from __future__ import annotations

import numpy as np

from ...core.constants import TEXT_TOKEN
from .common import PrefillInputs


def frame_index_token_type(image_mask: np.ndarray, token_per_frame: int) -> np.ndarray:
    """The reference's per-token frame index: -10 base, -1 text, the frame
    id on video tokens."""
    image_mask = np.asarray(image_mask, bool)
    out = np.full(image_mask.shape[0], -10, dtype=np.int32)
    out[~image_mask] = TEXT_TOKEN
    idx = np.nonzero(image_mask)[0]
    out[idx] = np.repeat(np.arange(len(idx) // token_per_frame, dtype=np.int32), token_per_frame)
    return out


def build_prefill_inputs(input_embeds, image_mask: np.ndarray, num_vit_patches: int,
                         pool_kernel_size: int = 2) -> PrefillInputs:
    """Spatial patch ids over the video span.

    Args:
        input_embeds: (S, D) embeddings (tensor or numpy) with the video
            features at the mask's rows.
        image_mask: (S,) bool, the video-token rows.
        num_vit_patches: ViT patches a frame before pooling.
        pool_kernel_size: the vision resampler's pooling kernel.
    """
    token_per_frame = num_vit_patches // (pool_kernel_size ** 2)
    s = input_embeds.shape[0]
    idx = np.nonzero(np.asarray(image_mask, bool))[0]
    if len(idx) == 0 or len(idx) % token_per_frame:
        raise ValueError(f"{len(idx)} video tokens are not a (nonzero) multiple of {token_per_frame} a frame")
    patch_type = np.full(s, TEXT_TOKEN, dtype=np.int32)
    patch_type[idx] = np.tile(np.arange(token_per_frame, dtype=np.int32), len(idx) // token_per_frame)
    start, end = int(idx[0]), int(idx[-1])
    return PrefillInputs(
        input_embeds=input_embeds,
        patch_type=patch_type,
        position_ids=np.arange(s, dtype=np.int32),
        patch_num=token_per_frame,
        image_token_start=start,
        image_token_length=end - start + 1,
        num_importance_queries=1,
    )
