"""LLaVA-Video adapter (port of ``framefusion_tpu.models.adapters.llava_video``).

  * 2x2 spatial pooling of the ViT grid: ``patch_size = ceil(side/2)`` for
    bilinear pooling, ``side // 2`` otherwise;
  * ``patch_num = patch_size * (patch_size + 1)``: the +1 column is the
    per-row ``image_newline`` token;
  * one contiguous video block at the <image> placeholder, text before and
    after; batch size 1, one video.
"""

from __future__ import annotations

import math

import numpy as np

from .common import PrefillInputs, contiguous_patch_type, splice_embeddings


def build_prefill_inputs(text_embeds, video_features, image_token_pos: int, num_patches_per_side: int = 27,
                         spatial_pool_mode: str = "average") -> PrefillInputs:
    """Fuse text + video features and derive FrameFusion metadata.

    Args:
        text_embeds: (T, D) token embeddings (tensor or numpy) with ONE
            <image> placeholder row.
        video_features: (n_frames * patch_num, D) pooled ViT features with
            the per-row newline tokens, as the LLaVA-Video frontend makes
            them; the same kind as ``text_embeds``.
        image_token_pos: index of the <image> placeholder row.
        num_patches_per_side: ViT patches per side (27 for SigLIP-so400m@384/14).
    """
    if spatial_pool_mode == "bilinear":
        patch_size = math.ceil(num_patches_per_side / 2)
    else:
        patch_size = num_patches_per_side // 2
    patch_num = patch_size * (patch_size + 1)

    image_token_length = video_features.shape[0]
    n_frames = image_token_length // patch_num
    if n_frames * patch_num != image_token_length:
        raise ValueError(f"video features ({image_token_length}) not a multiple of patch_num ({patch_num})")

    embeds = splice_embeddings(text_embeds, image_token_pos, video_features)
    total = embeds.shape[0]
    return PrefillInputs(
        input_embeds=embeds,
        patch_type=contiguous_patch_type(total, image_token_pos, patch_num, n_frames),
        position_ids=np.arange(total, dtype=np.int32),
        patch_num=patch_num,
        image_token_start=image_token_pos,
        image_token_length=image_token_length,
        num_importance_queries=1,
    )
