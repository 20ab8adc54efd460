"""NVILA adapter: video and multi-image prompts (port of
``framefusion_tpu.models.adapters.nvila``).

Parity: the reference's patched ``LlavaMetaForCausalLM._embed``
(models/nvila/llava_arch.py:40-104):

  * video: the frame count scaled down by the temporal pooling factor,
    ``patch_num = video_tokens / frames``;
  * multi-image: every image is one "frame" of ``patch_num = 1``, so the
    merge compares each token with the one before it across the span;
  * one contiguous media block at the placeholder, text before and after;
    the span from the first and last patch ids.

The embeddings splice as given (tensors on their device, or numpy arrays).
"""

from __future__ import annotations

import numpy as np

from .common import PrefillInputs, contiguous_patch_type, image_span, splice_embeddings


def _inputs(embeds, patch_type: np.ndarray, patch_num: int) -> PrefillInputs:
    start, _, length = image_span(patch_type)
    return PrefillInputs(
        input_embeds=embeds,
        patch_type=patch_type,
        position_ids=np.arange(embeds.shape[0], dtype=np.int32),
        patch_num=patch_num,
        image_token_start=start,
        image_token_length=length,
        num_importance_queries=1,
    )


def build_prefill_inputs_video(text_embeds, video_embeds, media_token_pos: int, num_frames: int,
                               temporal_pool_size: int = 1) -> PrefillInputs:
    """A video block of ``num_frames / temporal_pool_size`` frames at the
    placeholder row ``media_token_pos`` of ``text_embeds``."""
    eff_frames = int(num_frames / temporal_pool_size)
    n_tokens = video_embeds.shape[0]
    patch_num = n_tokens // eff_frames
    if patch_num * eff_frames != n_tokens:
        raise ValueError(f"{n_tokens} video tokens are not a multiple of {eff_frames} frames")
    embeds = splice_embeddings(text_embeds, media_token_pos, video_embeds)
    return _inputs(embeds, contiguous_patch_type(embeds.shape[0], media_token_pos, patch_num, eff_frames), patch_num)


def build_prefill_inputs_multi_image(text_embeds, image_embeds_list: list, media_token_pos: int) -> PrefillInputs:
    """Multi-image: the images spliced as one block at ``media_token_pos``,
    each token a frame of ``patch_num = 1``."""
    if isinstance(text_embeds, np.ndarray):
        media = np.concatenate(image_embeds_list, axis=0)
    else:
        import torch

        media = torch.cat(list(image_embeds_list))
    embeds = splice_embeddings(text_embeds, media_token_pos, media)
    return _inputs(embeds, contiguous_patch_type(embeds.shape[0], media_token_pos, 1, media.shape[0]), 1)
