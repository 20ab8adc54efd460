"""Framework utilities (port of ``framefusion_tpu.utils``).

The reference's dot-path attribute resolver and its frame-dump debug
helpers. (Its attention-weight extractor is
``ops.attention.last_rows_importance``, fused into the compute path.)
PIL and matplotlib are imported only by the dumps that use them.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def get_attr_by_name(obj: Any, name: str) -> Any:
    """Dot-path access with integer indexing, e.g. ``"layers.wq.0"``.

    Works on mappings (the port's params: dicts of tensors), ``nn.Module``s
    (submodules by name, ``ModuleList`` entries by index), sequences and
    tensors (an integer level indexes the leading axis), and any object's
    attributes."""
    current = obj
    for level in name.split("."):
        if isinstance(current, Mapping):
            current = current[level]
        elif level.isdigit():
            current = current[int(level)]
        else:
            current = getattr(current, level)
    return current


def tree_path_get(params: dict, path: str):
    """Alias of :func:`get_attr_by_name` for params trees."""
    return get_attr_by_name(params, path)


def _frames_numpy(video) -> np.ndarray:
    if isinstance(video, torch.Tensor):
        return video.detach().to("cpu", torch.float32).numpy()
    return np.asarray(video)


def _to_uint8_frame(frame: np.ndarray) -> np.ndarray:
    """[-1, 1] float frame (H, W, 3) -> uint8."""
    f = np.asarray(frame, np.float32)
    f = np.clip((f + 1.0) / 2.0, 0.0, 1.0)
    return (f * 255).astype(np.uint8)


def save_video_frames(video, output_path: str = "local/video_frames"):
    """Dump sampled frames as PNGs, ``frame_<i>.png``.

    Args:
        video: (n_frames, H, W, 3) in [-1, 1], a numpy array or a tensor.
    """
    from PIL import Image

    os.makedirs(output_path, exist_ok=True)
    for i, frame in enumerate(_frames_numpy(video)):
        Image.fromarray(_to_uint8_frame(frame)).save(os.path.join(output_path, f"frame_{i}.png"))


def save_video_frames_subfigures(video, output_path: str = "local/video_frames.jpg"):
    """One grid of subplots holding every frame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    video = _frames_numpy(video)
    n = len(video)
    rows = int(np.sqrt(n))
    cols = int(np.ceil(n / rows))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows), squeeze=False)
    axes = axes.flatten()
    for i in range(n):
        axes[i].imshow(_to_uint8_frame(video[i]))
        axes[i].axis("off")
        axes[i].set_title(f"Frame {i}")
    for i in range(n, len(axes)):
        axes[i].axis("off")
    plt.tight_layout()
    plt.savefig(output_path)
    plt.close(fig)
