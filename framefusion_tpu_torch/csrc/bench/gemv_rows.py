"""Kernels C and D at several activation rows and over routed rows, on the card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 framefusion_tpu_torch/csrc/bench/gemv_rows.py [--root DIR] [--json PATH]

Imports ``framefusion_tpu_torch`` from ``DIR`` (default: this checkout) and
builds its kernels there, so one call on the card can time two trees in
turns (unpack the other one with ``git archive`` into a git-ignored
directory and run parent, change, change, parent). The rows are
``chip_smoke.py``'s own (``_cd_rows``, ``_routed_row``: graph replays over
stacks cycled past the 50 MB L2, each call first held against its plain
version within ``GEMV_RTOL``):

* C (qkv, wo, w_down) and D (gate-up) at Qwen2-7B's decode widths, bf16 and
  int8, at 1 row, the batched decode's 2, 4 and 8 and the verify's 5 and 20;
* Qwen2-57B-A14B's routed expert gate-up (D) and down (C), int8, at 8 and
  64 rows (top-8 of 64 experts for 1 and 8 tokens), on 8-layer expert
  stacks (the model's widths; its 28 layers only add bytes that are not
  read).

Prints the card's name and power limit, each row, and writes every row's
numbers (ms, plain_ms, library_ms, bound_ms) to ``--json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose framefusion_tpu_torch is timed")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("gemv_rows: needs a CUDA card", file=sys.stderr)
        return 1
    import framefusion_tpu_torch
    from framefusion_tpu_torch import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    print(f"package: {Path(framefusion_tpu_torch.__file__).parent}")
    lib_path, seconds = _build.build()
    print(f"kernel build: {seconds:.1f} s -> {lib_path.name}")
    _build.load_library()

    chk, kernels = smoke.Checks(), smoke.kernels_table()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    hid, inter = 3584, 18944
    shapes = {"qkv": (hid, [hid, 512, 512]), "wo": (hid, [hid]), "w_down": (inter, [hid]),
              "gateup": (hid, [inter, inter])}
    rows = []
    for wdtype in ("bf16", "int8"):
        for name, (kdim, ns) in shapes.items():
            for entry in smoke._cd_rows(chk, kernels, gen, name, wdtype, kdim, ns, (1, 2, 4, 8, 5, 20)):
                rows.append(dict(entry, kernel="D" if name == "gateup" else "C"))
            torch.cuda.empty_cache()

    # Qwen2-57B-A14B's routed experts: 8 layers of 64 experts, 3,584 -> 2,560.
    n_l, n_e, top_k, moe_inter = 8, 64, 8, 2560
    w = [torch.randint(-127, 128, (n_l, n_e) + shape, generator=gen, device="cuda", dtype=torch.int8)
         for shape in ((hid, moe_inter), (hid, moe_inter), (moe_inter, hid))]
    sc = [torch.rand((n_l, n_e, moe_inter), generator=gen, device="cuda") * 0.01 + 0.005 for _ in range(2)]
    for tokens in (1, 8):
        sets = [torch.cat([(n_l - 1 - i) * n_e + torch.randperm(n_e, generator=gen, device="cuda")[:top_k]
                           for _ in range(tokens)]).to(torch.int32) for i in range(n_l)]
        rows.append(dict(smoke._routed_row(chk, kernels, gen, "gateup", w[:2], sc, sets, "routed"), kernel="D"))
        rows.append(dict(smoke._routed_row(chk, kernels, gen, "down", w[2:], [None], sets, "routed"), kernel="C"))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": smi.stdout.strip(), "root": args.root, "rows": rows}, indent=1))
    if chk.failures:
        print("FAILED: " + "; ".join(chk.failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
