"""MiniCPM-V 2.6 adapter (port of ``framefusion_tpu.models.adapters.minicpmv``).

Parity: the reference's patched ``get_vllm_embedding`` hook
(models/minicpmv/modeling_minicpmv.py:90-107):

  * ``token_per_frame`` = the distance between consecutive frames' first
    image rows, so it holds the two separator rows after each frame's
    resampled block;
  * patch ids are a running index modulo ``token_per_frame`` over
    ``[first bound start, last bound end + 2)``: the two separator rows of
    every frame carry patch ids too (the reference's quirk, kept);
  * the span from the first and last patch ids.

Pure numpy on the bounds: the embeddings pass through as given.
"""

from __future__ import annotations

import numpy as np

from ...core.constants import TEXT_TOKEN
from .common import PrefillInputs, image_span


def build_prefill_inputs(input_embeds, image_bound, num_frames: int) -> PrefillInputs:
    """Derive the metadata from MiniCPM-V's image-bound table.

    Args:
        input_embeds: (S, D) embeddings (tensor or numpy) with the vision
            features at their bounds.
        image_bound: (n_slices, 2) int, each vision slice's [start, end) in
            token space (the model's ``data["image_bound"][0]``).
        num_frames: frames in the video.
    """
    s = input_embeds.shape[0]
    image_bound = np.asarray(image_bound)
    patch_per_frame = image_bound.shape[0] // num_frames
    token_per_frame = int(image_bound[patch_per_frame, 0] - image_bound[0, 0])

    patch_type = np.full(s, TEXT_TOKEN, dtype=np.int32)
    lo, hi = int(image_bound[0, 0]), int(image_bound[-1, 1]) + 2
    patch_type[lo:hi] = np.arange(hi - lo, dtype=np.int32) % token_per_frame

    start, _, length = image_span(patch_type)
    return PrefillInputs(
        input_embeds=input_embeds,
        patch_type=patch_type,
        position_ids=np.arange(s, dtype=np.int32),
        patch_num=token_per_frame,
        image_token_start=start,
        image_token_length=length,
        num_importance_queries=1,
    )
