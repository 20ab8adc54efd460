"""InternVL2.5 adapter: interleaved ``FrameN: <image>`` prompts (port of
``framefusion_tpu.models.adapters.internvl``).

Parity: the reference's patched ``generate`` hook
(models/internvl/modeling_internvl_chat.py:38-83):

  * per-frame ``patch_num`` = the tower's tokens per tile;
  * patch_type = leading text + per frame [range(patch_num) + the frame's
    trailing text]: the text between frames keeps TEXT_TOKEN;
  * the InternLM2 backbone takes plain 1D positions (arange).

Pure numpy on the mask: the embeddings pass through as given (a tensor on
its device, or a numpy array).
"""

from __future__ import annotations

import numpy as np

from ...core.constants import TEXT_TOKEN
from .common import PrefillInputs


def build_prefill_inputs(input_embeds, image_mask: np.ndarray, tokens_per_frame: int) -> PrefillInputs:
    """Derive the metadata of an interleaved multi-frame InternVL prompt.

    Args:
        input_embeds: (S, D) embeddings (tensor or numpy) with the ViT
            features already at the image-context positions.
        image_mask: (S,) bool, True where image tokens live (the
            reference's ``selected`` mask over ``img_context_token_id``).
        tokens_per_frame: ViT tokens per frame (= patch_num).
    """
    image_mask = np.asarray(image_mask, bool)
    s = input_embeds.shape[0]
    if image_mask.shape != (s,):
        raise ValueError(f"image_mask {image_mask.shape} does not match the {s} embedding rows")
    img_idx = np.nonzero(image_mask)[0]
    if len(img_idx) == 0 or len(img_idx) % tokens_per_frame:
        raise ValueError(f"{len(img_idx)} image tokens are not a (nonzero) multiple of the frame size "
                         f"{tokens_per_frame}")
    n_frames = len(img_idx) // tokens_per_frame

    patch_type = np.full(s, TEXT_TOKEN, dtype=np.int32)
    # Each frame's block is contiguous; the interleaved text keeps TEXT_TOKEN.
    patch_type[img_idx] = np.tile(np.arange(tokens_per_frame, dtype=np.int32), n_frames)

    start, end = int(img_idx[0]), int(img_idx[-1])
    return PrefillInputs(
        input_embeds=input_embeds,
        patch_type=patch_type,
        position_ids=np.arange(s, dtype=np.int32),
        patch_num=tokens_per_frame,
        image_token_start=start,
        # NOTE reference quirk kept: the "image token length" is the SPAN
        # end - start + 1 (modeling_internvl_chat.py:60), which for
        # interleaved prompts includes the text between frames; the prune
        # window therefore covers that text too, exactly as upstream.
        image_token_length=end - start + 1,
        num_importance_queries=1,
    )
