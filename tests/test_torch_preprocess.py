"""The port's native preprocessing against the JAX package's NumPy path.

``framefusion_tpu_torch.preprocess.preprocess_frames(impl="native")`` runs
``csrc/prep.cpp``: one fused pass that reads the caller's uint8 frames as
they are (float frames through the same kernel). Held here, on 360x480
frames, against ``framefusion_tpu.preprocess.preprocess_frames(impl="numpy")``
at every family's geometry (SigLIP 384, InternVL 448, MiniCPM-V's 980
upscale, Qwen2-VL's non-square ``smart_resize``, and a 28x28 target whose
one-frame call has fewer tasks than the host has threads), both filters,
and 1, 3 and 17 frames. uint8 and float32 frames of the same values give
the same pixels; every call returns a fresh array; ``path_counts`` says
which path ran.
"""

import numpy as np
import pytest

from framefusion_tpu import preprocess as jpp
from framefusion_tpu_torch import native
from framefusion_tpu_torch import preprocess as tpp

# (family, preprocess_frames geometry keywords)
GEOMETRIES = {
    "siglip384": ("llava_video", {"target": (384, 384)}),
    "internvl448": ("internvl", {"target": (448, 448)}),
    "minicpmv980": ("minicpmv", {"target": (980, 980)}),
    "qwen2vl_smart": ("qwen2_vl", {"factor": 28}),
    "tiny28": ("nvila", {"target": (28, 28)}),
}


@pytest.fixture(scope="module")
def lib():
    lib = native.load(required=False)
    if lib is None:
        pytest.skip(f"no native toolchain (g++): {native._LOADER.error}")
    return lib


# 17 frames at 980x980 would hold ~0.2 GB an array and ~2 GB in all: 980 runs 1 and 3
CASES = [(g, n) for g in sorted(GEOMETRIES) for n in (1, 3, 17) if (g, n) != ("minicpmv980", 17)]


@pytest.mark.parametrize("resample", ["bilinear", "bicubic"])
@pytest.mark.parametrize("geometry, frames_n", CASES)
def test_native_matches_jax_numpy(lib, geometry, resample, frames_n):
    family, kw = GEOMETRIES[geometry]
    frames = np.random.default_rng(frames_n).integers(0, 256, (frames_n, 360, 480, 3), dtype=np.uint8)
    want = jpp.preprocess_frames(frames, family, resample=resample, impl="numpy", **kw)

    before = dict(tpp.path_counts)
    got = tpp.preprocess_frames(frames, family, resample=resample, impl="native", **kw)
    assert tpp.path_counts["native_u8"] == before["native_u8"] + 1
    from_float = tpp.preprocess_frames(frames.astype(np.float32), family, resample=resample, impl="native", **kw)
    assert tpp.path_counts["native_float"] == before["native_float"] + 1
    assert tpp.path_counts["numpy"] == before["numpy"]

    assert got.dtype == np.float32 and got.shape == want.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got, from_float)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    again = tpp.preprocess_frames(frames, family, resample=resample, impl="native", **kw)
    assert not np.shares_memory(got, again) and not np.shares_memory(got, from_float)
    np.testing.assert_array_equal(got, again)


def test_numpy_path_is_counted():
    frames = np.random.default_rng(0).integers(0, 256, (2, 36, 48, 3), dtype=np.uint8)
    before = dict(tpp.path_counts)
    tpp.preprocess_frames(frames, "llava_video", target=(28, 28), impl="numpy")
    assert tpp.path_counts == {**before, "numpy": before["numpy"] + 1}


def test_strided_uint8_frames(lib):
    frames = np.random.default_rng(1).integers(0, 256, (4, 40, 60, 3), dtype=np.uint8)
    view = frames[::2, :, ::-1]  # every other frame, mirrored: not contiguous
    before = tpp.path_counts["native_u8"]
    got = tpp.preprocess_frames(view, "internvl", target=(32, 24), impl="native")
    assert tpp.path_counts["native_u8"] == before + 1
    np.testing.assert_array_equal(got, tpp.preprocess_frames(np.ascontiguousarray(view), "internvl", target=(32, 24),
                                                             impl="native"))
    np.testing.assert_allclose(got, jpp.preprocess_frames(view, "internvl", target=(32, 24), impl="numpy"),
                               rtol=1e-4, atol=1e-5)
