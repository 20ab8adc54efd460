"""Qwen2-VL adapter (port of ``framefusion_tpu.models.adapters.qwen2_vl``):
one contiguous video block and 3D mRoPE positions.

Parity: the reference's patched ``Qwen2VLForConditionalGeneration.forward``
(qwenvl/modeling_qwen2_vl.py:117-163):

  * ``patch_num = (grid_h * grid_w) / spatial_merge_size^2``;
  * patch_type tiles ``range(patch_num)`` per (merged) temporal frame;
  * 3D rope index streams (temporal, height, width), HF
    ``Qwen2VLModel.get_rope_index``'s layout for one video;
  * importance from the last 4 query rows.

Pure numpy: the position rule is the JAX package's, copied whole.
"""

from __future__ import annotations

import numpy as np

from .common import PrefillInputs, contiguous_patch_type, splice_embeddings


def mrope_position_ids(total_len: int, video_start: int, grid_t: int, grid_h: int, grid_w: int,
                       spatial_merge_size: int = 2, second_per_grid_ts: float | None = None,
                       tokens_per_second: int = 2) -> np.ndarray:
    """(3, S) int32 positions: text advances all three streams together;
    video tokens get (t, h, w) grid coordinates offset by the text position,
    and the text after the video resumes from max(position) + 1, the layout
    HF ``Qwen2VLModel.get_rope_index`` makes for one video.

    ``second_per_grid_ts`` switches to Qwen2.5-VL's temporal spacing
    (``Qwen2_5_VLModel.get_rope_index``): the temporal stream advances by
    ``t_idx * second_per_grid_ts * tokens_per_second``, h/w and the text
    rule unchanged. As in transformers 4.57, ``second_per_grid_ts`` is cast
    to an integer before the multiply, so fractional seconds truncate.
    """
    h = grid_h // spatial_merge_size
    w = grid_w // spatial_merge_size
    n_video = grid_t * h * w
    pos = np.zeros((3, total_len), dtype=np.int32)
    pos[:, :video_start] = np.arange(video_start, dtype=np.int32)[None, :]
    t_idx = np.repeat(np.arange(grid_t, dtype=np.int32), h * w)
    if second_per_grid_ts is not None:
        t_idx = (t_idx.astype(np.int64) * int(second_per_grid_ts) * tokens_per_second).astype(np.int32)
    h_idx = np.tile(np.repeat(np.arange(h, dtype=np.int32), w), grid_t)
    w_idx = np.tile(np.arange(w, dtype=np.int32), grid_t * h)
    block = slice(video_start, video_start + n_video)
    pos[0, block] = video_start + t_idx
    pos[1, block] = video_start + h_idx
    pos[2, block] = video_start + w_idx
    tail_start = int(pos[:, : video_start + n_video].max()) + 1
    n_tail = total_len - (video_start + n_video)
    pos[:, video_start + n_video:] = (tail_start + np.arange(n_tail, dtype=np.int32))[None, :]
    return pos


def build_prefill_inputs(text_embeds, video_embeds, video_token_pos: int, grid_t: int, grid_h: int, grid_w: int,
                         spatial_merge_size: int = 2, second_per_grid_ts: float | None = None,
                         tokens_per_second: int = 2) -> PrefillInputs:
    """Fuse text + Qwen2-VL visual embeddings and derive the metadata.

    Args:
        text_embeds: (T, D) (tensor or numpy) with ONE video placeholder row
            at ``video_token_pos``.
        video_embeds: (grid_t * grid_h * grid_w / merge^2, D) from the
            tower, the same kind as ``text_embeds``.
        grid_*: the video_grid_thw entries (t already temporally merged).
    """
    patch_num = (grid_h * grid_w) // (spatial_merge_size * spatial_merge_size)
    image_token_length = video_embeds.shape[0]
    n_frames = image_token_length // patch_num
    if n_frames != grid_t or n_frames * patch_num != image_token_length:
        raise ValueError(f"video embeddings ({image_token_length} rows) do not match the grid "
                         f"({grid_t}, {grid_h}, {grid_w}) at merge {spatial_merge_size}")
    embeds = splice_embeddings(text_embeds, video_token_pos, video_embeds)
    total = embeds.shape[0]
    return PrefillInputs(
        input_embeds=embeds,
        patch_type=contiguous_patch_type(total, video_token_pos, patch_num, n_frames),
        position_ids=mrope_position_ids(total, video_token_pos, grid_t, grid_h, grid_w, spatial_merge_size,
                                        second_per_grid_ts=second_per_grid_ts,
                                        tokens_per_second=tokens_per_second),
        patch_num=patch_num,
        image_token_start=video_token_pos,
        image_token_length=image_token_length,
        num_importance_queries=4,
    )
