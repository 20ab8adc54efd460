"""Build-on-demand ctypes bindings for the native frame preprocessing.

The C++ source is the port's own ``csrc/prep.cpp``: one fused pass from the
caller's uint8 (or float32) frames to normalized float32 pixels, with the
same math as the JAX package's ``native/prep.cpp`` and the NumPy twin in
preprocess.py (the port reads none of the JAX package's files; that package
imports jax through its ``__init__``). ``load()`` compiles it with the
system g++ the first time, into ``_build/libffprep-<hash>.so`` beside this
file (keyed on the source and the flags, so an edit to either rebuilds), and
returns the loaded library, or ``None`` when no toolchain is available and
the caller did not require it (callers then run the NumPy twin, which
computes the same math). ctypes releases the GIL for the call, so the
threaded resize overlaps the Python thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "prep.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_RESAMPLE = {"bilinear": 0, "bicubic": 1}
# Baseline ISA only, so a library built on one host loads on any other;
# products and sums stay apart (no FMA) so results match the JAX package's
# kernel bit for bit on every target.
_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", "-std=c++17"]


class _Loader:
    """The process's one library handle, or the reason it could not be built."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib = None
        self.error: Optional[str] = None


_LOADER = _Loader()


def _build() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libffprep-{tag}.so"
    if not so.exists():
        # A temp file per process, then an atomic rename: processes compiling
        # at once (parallel test workers) never leave a torn library behind.
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, str(SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    return so


def load(required: bool = False):
    """Compile (once) and load the native library; None if unavailable and
    not ``required`` (then the failure is remembered and not retried)."""
    with _LOADER.lock:
        if _LOADER.lib is not None:
            return _LOADER.lib
        if _LOADER.error is not None and not required:
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError) as exc:
            _LOADER.error = repr(exc)
            if required:
                raise RuntimeError(f"native preprocessing unavailable: {exc!r}") from exc
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        dims = [ctypes.c_int] * 7
        lib.ff_resize_frames.argtypes = [f32p, *dims, f32p, f32p, ctypes.c_float, f32p]
        lib.ff_resize_frames.restype = None
        lib.ff_resize_frames_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8), *dims, f32p, f32p, ctypes.c_float, f32p]
        lib.ff_resize_frames_u8.restype = None
        lib.ff_normalize.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, f32p, f32p, ctypes.c_float]
        lib.ff_normalize.restype = None
        _LOADER.lib = lib
        return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_frames(lib, frames: np.ndarray, out_h: int, out_w: int, resample: str,
                  normalize: Optional[tuple] = None) -> np.ndarray:
    """(T, H, W, C) uint8 or float -> (T, out_h, out_w, C) float32 through
    the native threaded kernel, into a fresh array. uint8 frames are read as
    they are; other dtypes are converted to float32 once.
    ``normalize=(mean, std, rescale)`` fuses the normalization into the
    kernel's epilogue."""
    t, h, w, c = frames.shape
    if frames.dtype == np.uint8:
        frames = np.ascontiguousarray(frames)
        entry, src = lib.ff_resize_frames_u8, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        frames = np.ascontiguousarray(frames, np.float32)
        entry, src = lib.ff_resize_frames, _f32p(frames)
    out = np.empty((t, out_h, out_w, c), np.float32)
    null = ctypes.POINTER(ctypes.c_float)()
    mp, sp, rs = null, null, 1.0
    if normalize is not None:
        mean, std, rescale = normalize
        mean = np.ascontiguousarray(mean, np.float32)
        std = np.ascontiguousarray(std, np.float32)
        if mean.shape != (c,) or std.shape != (c,):
            raise ValueError(f"mean/std must have {c} channels")
        mp, sp, rs = _f32p(mean), _f32p(std), float(rescale)
    entry(src, t, h, w, c, out_h, out_w, _RESAMPLE[resample], mp, sp, rs, _f32p(out))
    return out


def normalize_frames(lib, frames: np.ndarray, mean, std, rescale: float) -> np.ndarray:
    """``(frames * rescale - mean) / std`` over the trailing channel axis,
    threaded (``ff_normalize``); in place when ``frames`` is already
    contiguous float32, else on a contiguous float32 copy, which is
    returned."""
    frames = np.ascontiguousarray(frames, np.float32)
    c = frames.shape[-1]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"mean/std must have {c} channels")
    lib.ff_normalize(_f32p(frames), frames.size // c, c, _f32p(mean), _f32p(std), float(rescale))
    return frames
