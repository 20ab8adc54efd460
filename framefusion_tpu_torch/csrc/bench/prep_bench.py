"""Host preprocessing on the host's cores: ms a frame and share of copy bandwidth.

Run from the repository root (no card needed):

    python3 framefusion_tpu_torch/csrc/bench/prep_bench.py [--root DIR] [--reps N] [--json PATH]

Imports ``framefusion_tpu_torch`` from ``DIR`` (default: this checkout) and
builds its native library there, so one run can time two trees in turns
(unpack the other one with ``git archive`` into a git-ignored directory and
run parent, change, change, parent). For 16, 32 and 64 uint8 360x480 frames
to 384x384 and 448x448 it times ``preprocess_frames(impl="native")`` as the
served path calls it (SigLIP statistics, bicubic, a fresh output a call), the
median of ``--reps`` calls after one warm-up call, and prints:

* ms a frame;
* GB/s: uint8 in plus float32 out over that time;
* its share of the host's copy bandwidth, measured the same way: ``np.copyto``
  of a float32 array the size of the output into a fresh one, split over as
  many Python threads as the native kernel starts (``os.cpu_count()``),
  counting bytes read plus bytes written.

Prints the CPU model and thread counts first; ``--json`` writes the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[3]
FRAMES = (16, 32, 64)
SIZES = (384, 448)
H, W = 360, 480


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _median_s(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def copy_gbps(n_floats: int, threads: int, reps: int) -> float:
    """Read + write GB/s of a threaded ``np.copyto`` into a fresh array."""
    src = np.random.default_rng(0).random(n_floats, dtype=np.float32)
    bounds = np.linspace(0, n_floats, threads + 1).astype(np.int64)
    with ThreadPoolExecutor(threads) as pool:
        def copy():
            dst = np.empty_like(src)
            list(pool.map(lambda i: np.copyto(dst[bounds[i]:bounds[i + 1]], src[bounds[i]:bounds[i + 1]]),
                          range(threads)))
        seconds = _median_s(copy, reps)
    return 2 * src.nbytes / seconds / 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose framefusion_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=7, help="timed calls a row (after one warm-up call)")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import framefusion_tpu_torch
    from framefusion_tpu_torch import native, preprocess

    threads = os.cpu_count() or 1
    affinity = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else threads
    print(f"cpu: {_cpu_model()}; os.cpu_count {threads}, affinity {affinity}")
    print(f"package: {Path(framefusion_tpu_torch.__file__).parent}")
    native.load(required=True)
    frames = np.random.default_rng(0).integers(0, 256, (max(FRAMES), H, W, 3), dtype=np.uint8)
    rows = []
    for size in SIZES:
        for t in FRAMES:
            video = frames[:t]
            seconds = _median_s(lambda: preprocess.preprocess_frames(video, "llava_video", target=(size, size),
                                                                     impl="native"), args.reps)
            out_bytes = t * size * size * 3 * 4
            gbps = (video.nbytes + out_bytes) / seconds / 1e9
            copy = copy_gbps(out_bytes // 4, threads, args.reps)
            row = {"size": size, "frames": t, "ms_per_frame": seconds * 1e3 / t, "gbps": gbps,
                   "copy_gbps": copy, "copy_share": gbps / copy}
            rows.append(row)
            print(f"{H}x{W} -> {size}x{size}, {t:2d} frames: {row['ms_per_frame']:.4f} ms a frame, "
                  f"{gbps:.2f} GB/s, copy {copy:.2f} GB/s, share {row['copy_share']:.3f}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"cpu": _cpu_model(), "threads": threads, "affinity": affinity,
                                               "root": str(Path(args.root).resolve()), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
