"""Per-CTA timeline of kernel C (``gemv_stacked``) on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 framefusion_tpu_torch/csrc/bench/gemv_timeline.py

Builds an instrumented copy of ``csrc/matvec.cu`` in a temporary directory
(the kernel itself carries no probes): thread 0 of every CTA reads the
card's global timer (``%globaltimer``, ns) at its start, when the first ring
stage has landed, at the end of its K loop, after its arrival ticket and,
in the CTA that merges a column tile, at the end of the merge. Then runs the
decode shapes (qkv, wo, w_down; bf16 and int8) on cold layers (stacks cycled
past the 50 MB L2) and prints, per shape, the p50 / p90 / max over the CTAs
of each point (µs after the first CTA's start) and of each phase.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

from framefusion_tpu_torch import _build  # noqa: E402
from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv  # noqa: E402
from framefusion_tpu_torch.ops.kernels.decode_attention import MAX_COUNTERS  # noqa: E402
from framefusion_tpu_torch.ops.quant import quantize_weight  # noqa: E402

# (anchor in matvec.cu, text inserted after it): the probe points.
PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_probe[4096][5];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("lane = threadIdx.x & 31;\n",
     "  const int pid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "  if (threadIdx.x == 0 && pid < 4096) { g_probe[pid][0] = gtime(); g_probe[pid][4] = 0; }\n"),
    ("// the stage has landed\n", "    if (i == 0 && threadIdx.x == 0 && pid < 4096) g_probe[pid][1] = gtime();\n"),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(empty0 + slot * 8);  // this warp is done with the stage\n  }\n",
     "  if (threadIdx.x == 0 && pid < 4096) g_probe[pid][2] = gtime();\n"),
]


def instrumented_source() -> str:
    src = (_build.CSRC_DIR / "matvec.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in matvec.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    # the ticket: just before the CTAs that do not merge leave; the merge's end: the kernel's last line
    ticket = "  consumers_sync();\n  if (!*is_last) return;\n"
    if src.count(ticket) != 1:
        raise RuntimeError("the ticket was not found once in matvec.cu")
    src = src.replace(ticket, "  consumers_sync();\n  if (threadIdx.x == 0 && pid < 4096) g_probe[pid][3] = gtime();\n"
                      "  if (!*is_last) return;\n")
    tail = "    if (gc < n) out[gc] = part[h];\n  }\n}\n"
    if src.count(tail) != 1:
        raise RuntimeError("the merge's end was not found once in matvec.cu")
    src = src.replace(tail, tail[:-2] + "  if (threadIdx.x == 0 && pid < 4096) g_probe[pid][4] = gtime();\n}\n")
    return src + ('\nextern "C" int ff_probe_read(void* dst) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe)));\n}\n")


def build(tmp: Path) -> ctypes.CDLL:
    cu = tmp / "matvec_probe.cu"
    cu.write_text(instrumented_source())
    so = tmp / "libgemv_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.ff_gemv_stacked.argtypes = _build.ENTRY_POINTS["ff_gemv_stacked"]
    lib.ff_probe_read.argtypes = [ctypes.c_void_p]
    return lib


def run(lib, x, stacks, layer, counters) -> None:
    wtype, tiles, chunks, kchunk = mv._kernel_plan(x, stacks, 1)
    ns = [w.shape[2] for w in stacks]
    outs = [torch.empty((1, n), dtype=torch.float32, device="cuda") for n in ns]
    ws = torch.empty((chunks, 1, sum(ns)), dtype=torch.float32, device="cuda")
    pad = 3 - len(stacks)
    status = lib.ff_gemv_stacked(x.data_ptr(), 1, x.shape[1], x.shape[1], layer, stacks[0].shape[0], wtype,
                                 *([w.data_ptr() for w in stacks] + [None] * pad), *(ns + [0] * pad),
                                 *([o.data_ptr() for o in outs] + [None] * pad), ws.data_ptr(), counters.data_ptr(),
                                 chunks, kchunk, None, 1, _build.stream_ptr(x.device))
    _build.check(status, "gemv_stacked (instrumented)")


def pct(a) -> str:
    return f"{np.percentile(a, 50) / 1e3:.2f} / {np.percentile(a, 90) / 1e3:.2f} / {a.max() / 1e3:.2f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("gemv_timeline: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    counters = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        for wdtype in ("bf16", "int8"):
            for name, (k, ns) in {"qkv": (3584, [3584, 512, 512]), "wo": (3584, [3584]),
                                  "w_down": (18944, [3584])}.items():
                n_layers = max(2, math.ceil(150e6 / (k * sum(ns) * (1 if wdtype == "int8" else 2))))
                x = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
                stacks = []
                for n in ns:
                    w = (torch.randn((n_layers, k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
                    stacks.append(quantize_weight(w)["q8"] if wdtype == "int8" else w)
                for layer in range(1, n_layers):  # layer 0 is cold when it runs
                    run(lib, x, stacks, layer, counters)
                run(lib, x, stacks, 0, counters)
                torch.cuda.synchronize()
                buf = np.zeros((4096, 5), dtype=np.uint64)
                if lib.ff_probe_read(buf.ctypes.data) != 0:
                    raise RuntimeError("reading the probes failed")
                _, tiles, chunks, kchunk = mv._kernel_plan(x, stacks)
                t = buf[:tiles * chunks].astype(np.int64)
                t -= t[:, 0].min()
                merged = buf[:tiles * chunks, 4] > 0
                print(f"{name} {wdtype}: {tiles * chunks} CTAs ({tiles} column tiles x {chunks} K-chunks of {kchunk}), "
                      f"us p50 / p90 / max: start {pct(t[:, 0])}; first stage landed {pct(t[:, 1])}; K loop end "
                      f"{pct(t[:, 2])}; ticket {pct(t[:, 3])}; merge end {pct(t[merged, 4])}. Per CTA: first-stage "
                      f"latency {pct(t[:, 1] - t[:, 0])}, stream {pct(t[:, 2] - t[:, 1])}, reduce + ticket "
                      f"{pct(t[:, 3] - t[:, 2])}, merge {pct(t[merged, 4] - t[merged, 3])}", flush=True)
                del stacks
    return 0


if __name__ == "__main__":
    sys.exit(main())
