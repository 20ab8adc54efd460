"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, at first use, into ``_build/`` beside this file (listed in
``.gitignore``). The library's name carries a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once. The library
is loaded with ``ctypes``; each kernel module declares the argument types of
its entry points.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libff_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if no library for them exists yet.

    Returns (library path, seconds spent compiling — 0.0 when it existed).
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib, time.perf_counter() - t0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Entry point -> argument types; every entry point returns an int (a
# cudaError_t, or a size for the *_smem / *_max_* queries).
ENTRY_POINTS = {
    "ff_flash_attn_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ff_attn_importance_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "ff_attn_importance_rows_smem": [_I, _I],
    "ff_gemv_stacked": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    "ff_gemv_gateup": [_P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P],
    "ff_gemv_max_kchunk": [],
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' shared library (once per process)."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
