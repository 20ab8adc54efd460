"""Find the highest request rate a cell's serving loop sustains: the sweep on the card.

    python3 -m ffbench.sweep --workload llava7b.qa --seed 5 --seconds 30 --rates 1.0,1.5,2.0

One program, built and warmed up once; for each rate in turn, the cell's
traffic mix at that rate for ``--seconds``, drained. Prints a JSON line a
rate: requests due, the rate completed (requests over the time to the last
answer), answer tokens a second read back in the window, p50 and p90 of the
answer latency, and the backlog's growth (the median latency of the last
third of the requests over that of the first third; about 1 when the loop
keeps up). The benchmark's runs do not run it; a cell's fixed rate comes
from it.
"""

from __future__ import annotations

import argparse
import json
import statistics

from . import generator, serve, stats, tracing
from .run import HERE, Bench, log, prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Sweep a cell's arrival rate.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("ffbench.sweep: needs a CUDA card")
        return 2
    bench = Bench(HERE.parent / "BENCHMARK.json")
    st = prepare(bench, args.workload, args.seed, "cuda")
    skip = set(st.warm_rids)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        requests = generator.schedule(st.traffic, rate, args.seconds, args.seed + 1 + i)
        frames = generator.draw_frames(requests, args.seed + 1 + i, st.traffic["frame_shape"], "cuda")
        window = serve.run(st.program, st.loop, requests, frames, args.seconds, tracing.Tracer(False), set(), True,
                           skip)
        skip |= {r.rid for r in window.records if r.rid is not None}
        lat = stats.latencies_s(window.records, max(r.done_s or 0.0 for r in window.records))
        third = max(1, len(lat) // 3)
        last_done = max(r.done_s or 0.0 for r in window.records)
        print(json.dumps({
            "workload": args.workload, "rate_rps": rate, "requests": len(requests),
            "completed_rps": len([r for r in window.records if r.tokens]) / last_done,
            "tokens_per_s": stats.rate(window.tokens, window.seconds),
            "p50_ms": 1e3 * stats.nearest_rank(lat, 50), "p90_ms": 1e3 * stats.nearest_rank(lat, 90),
            "growth": statistics.median(lat[-third:]) / statistics.median(lat[:third]),
            "failed": sum(1 for r in window.records if r.error is not None)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
