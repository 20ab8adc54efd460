"""Readings that set a cell's correctness limits: sound runs and the control, seed by seed.

    python3 -m ffbench.calibrate --workload llava7b.qa --seeds 11,12,13 --seconds 12

Each seed is a whole run of the cell (its own weights, traffic and sample)
at the cell's rate with a short window, whose sample is then read twice:
by the reference, as every run does (the lower readings), and by the
control, the reference in the next precision down put in the program's
place (the upper readings). The control's readings are then judged
against the cell's limits as the program's are (``check.judge``): its
``control_correct`` has to come out false. One process serves every seed.
Prints a JSON line a seed. The benchmark's runs do not run the control.
"""

from __future__ import annotations

import argparse
import json

from . import check
from .run import HERE, Bench, forbidden_modules, log, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Sound and control readings of a cell's compared numbers.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("ffbench.calibrate: needs a CUDA card")
        return 2
    bench = Bench(HERE.parent / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = run_cell(bench, args.workload, seed, args.seconds, False, control=True)
        readings = {k: c["value"] for k, c in checks.items()}
        control_correct, _ = check.judge(check.control_values(readings), bench.cell(args.workload)["limits"], 0, 0)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "control_correct": control_correct, "readings": readings}), flush=True)
    if forbidden_modules():
        log(f"forbidden modules loaded: {forbidden_modules()}")
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
