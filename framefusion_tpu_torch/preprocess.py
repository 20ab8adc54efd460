"""Host-side image/video preprocessing: raw uint8 frames -> model pixels
(port of ``framefusion_tpu.preprocess``; the JAX module imports no jax, but
its package does, so the port carries its own copy).

Resize semantics are PIL's, which the HF processors assume: separable
convolution with the filter support scaled by the downscale factor (always
antialiased), half-pixel centers, weights normalized per output pixel;
uint8 inputs are converted once to float32 and resized in float. The hot
loops also have a native C++ implementation (``native.py`` builds the JAX
package's ``native/prep.cpp``), with this NumPy path as its twin.

Normalization constants per family follow the upstream processors: CLIP
stats for Qwen2-VL, ImageNet for InternVL, 0.5/0.5 for the SigLIP-fronted
families (LLaVA-Video / LLaVA-NeXT-Video / MiniCPM-V / NVILA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_SIGLIP_MEAN = (0.5, 0.5, 0.5)
_SIGLIP_STD = (0.5, 0.5, 0.5)

FAMILY_IMAGE_STATS = {
    "qwen2_vl": (_CLIP_MEAN, _CLIP_STD),
    "internvl": (_IMAGENET_MEAN, _IMAGENET_STD),
    "llava_video": (_SIGLIP_MEAN, _SIGLIP_STD),
    "llava_next_video": (_SIGLIP_MEAN, _SIGLIP_STD),
    "minicpmv": (_SIGLIP_MEAN, _SIGLIP_STD),
    "nvila": (_SIGLIP_MEAN, _SIGLIP_STD),
}


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    resample: str = "bicubic"  # HF processors default to bicubic
    rescale: float = 1.0 / 255.0


def _filter_fn(resample: str):
    if resample == "bilinear":
        def f(x):
            x = np.abs(x)
            return np.where(x < 1.0, 1.0 - x, 0.0)
        return f, 1.0
    if resample == "bicubic":
        a = -0.5  # Keys cubic, PIL / torchvision convention

        def f(x):
            x = np.abs(x)
            return np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))
        return f, 2.0
    raise ValueError(f"unknown resample {resample!r} (bilinear|bicubic)")


def resize_weights(in_size: int, out_size: int, resample: str = "bicubic") -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic resize matrix, PIL
    semantics: half-pixel centers, filter support scaled by the downscale
    factor (antialiasing), per-row weight normalization."""
    f, _ = _filter_fn(resample)
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale  # input coords
    idx = np.arange(in_size, dtype=np.float64)
    w = f((idx[None, :] + 0.5 - centers[:, None]) / fscale)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize_frames(frames: np.ndarray, out_h: int, out_w: int, resample: str = "bicubic", impl: str = "auto",
                  normalize: Optional[tuple] = None) -> np.ndarray:
    """Resize (T, H, W, C) or (H, W, C) frames to (..., out_h, out_w, C)
    float32. ``impl``: "numpy", "native" (C++ threads; raises if it cannot
    be built), or "auto" (native when it builds and loads, else numpy).
    ``normalize=(mean, std, rescale)`` applies the normalization epilogue
    (fused into the native kernel's column pass; after the resize on the
    numpy path)."""
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown impl {impl!r} (auto|native|numpy)")
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    frames = np.ascontiguousarray(frames, np.float32)
    _, h, w, _ = frames.shape
    if impl != "numpy":
        from . import native

        lib = native.load(required=impl == "native")
        if lib is not None:
            out = native.resize_frames(lib, frames, out_h, out_w, resample, normalize=normalize)
            return out[0] if squeeze else out
    wy = resize_weights(h, out_h, resample)
    wx = resize_weights(w, out_w, resample)
    # separable: rows then columns, as the C++ twin goes
    tmp = np.einsum("oh,thwc->towc", wy, frames, optimize=True)
    out = np.einsum("ow,thwc->thoc", wx, tmp, optimize=True)
    if normalize is not None:
        mean, std, rescale = normalize
        out = normalize_frames(out, mean, std, rescale=rescale)
    out = np.ascontiguousarray(out, np.float32)
    return out[0] if squeeze else out


def normalize_frames(frames: np.ndarray, mean: Sequence[float], std: Sequence[float],
                     rescale: float = 1.0 / 255.0) -> np.ndarray:
    """(x * rescale - mean) / std over the trailing channel axis, float32."""
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    return (np.asarray(frames, np.float32) * np.float32(rescale) - m) / s


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Qwen2-VL's target-geometry rule: round H/W to multiples of ``factor``
    (patch_size * spatial_merge_size), then scale into the
    [min_pixels, max_pixels] budget preserving the aspect ratio."""
    if height < factor or width < factor:
        raise ValueError(f"height/width must be >= factor {factor}, got {height}x{width}")
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_frames(frames: np.ndarray, family: str, *, target: Optional[Tuple[int, int]] = None,
                      factor: Optional[int] = None, max_pixels: Optional[int] = None,
                      resample: Optional[str] = None, impl: str = "auto") -> np.ndarray:
    """Raw (T, H, W, C) uint8/float frames -> normalized float32 model pixels
    at the family's geometry.

    ``target=(h, w)`` forces the output size (a fixed-size ViT's
    ``image_size``); otherwise ``factor`` (patch * merge) selects Qwen2-VL's
    :func:`smart_resize` geometry. Fuses resize + rescale + normalize.
    """
    mean, std = FAMILY_IMAGE_STATS[family]
    cfg = PreprocessConfig(mean=mean, std=std)
    resample = resample or cfg.resample
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    _, h, w, _ = frames.shape
    if target is None:
        if factor is None:
            raise ValueError("pass target=(h, w) or, for qwen2_vl-style geometry, factor=")
        kwargs = {} if max_pixels is None else {"max_pixels": max_pixels}
        target = smart_resize(h, w, factor=factor, **kwargs)
    return resize_frames(frames.astype(np.float32), target[0], target[1], resample=resample, impl=impl,
                         normalize=(mean, std, cfg.rescale))
