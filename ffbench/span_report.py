"""One traced run of a cell, with the device's idle time split by the program's spans.

    python3 -m ffbench.span_report --workload <name> --seed <n> [--seconds <s>] [--out FILE]

The run is ``run.run_cell`` with ``--trace 1``. The harness's trace reader
keeps the device's operations and its own ``ffbench.*`` ranges; here the
program's ``framefusion.*`` spans are read from the same Chrome trace too
(``spans.parse_events``) and handed to the trace as ``trace.spans``, where
the span readers in ``metrics/`` find them. The last line of standard
output is one JSON object: the run's result line, the span readings, the
device idle of the window by innermost span (``spans.idle_by_span``), the
idle under the ``ffbench.step`` ranges and the share the admissions and
chunks cover (``spans.step_coverage``), and the idle inside each span name.
``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


@contextlib.contextmanager
def program_spans():
    """Hand each parsed trace the program's spans from its file; yields
    the list of traces parsed."""
    from . import spans, tracing

    parse, parsed = tracing.parse_chrome_trace, []

    def with_spans(path):
        trace = parse(path)
        with open(path) as f:
            trace.spans = spans.parse_events(json.load(f)["traceEvents"])
        parsed.append(trace)
        return trace

    tracing.parse_chrome_trace = with_spans
    try:
        yield parsed
    finally:
        tracing.parse_chrome_trace = parse


def report(trace) -> dict:
    from . import spans

    found = trace.spans
    counts: dict = {}
    for s in found:
        counts[s.name] = counts.get(s.name, 0) + 1
    admits = spans.started_in_window(trace, found, "serve.admit")
    chunks = spans.started_in_window(trace, found, "serve.chunk")
    return {
        "window_s": trace.window_s, "busy_s": trace.busy_s(), "span_counts": counts,
        "admit_idle_ms": spans.idle_ms_per_span(trace, found, "serve.admit"),
        "chunk_idle_ms": spans.idle_ms_per_span(trace, found, "serve.chunk"),
        "queue_wait_ms": spans.queue_wait_ms(trace, found),
        "prefill_fallback_pct": spans.fallback_pct(trace, found),
        "admissions": len(admits), "admit_ms": [(s.end_us - s.start_us) * 1e-3 for s in admits],
        "chunks": len(chunks), "chunk_ms": [(s.end_us - s.start_us) * 1e-3 for s in chunks],
        "chunk_active": [s.n for s in chunks],
        "step_coverage": spans.step_coverage(trace, found),
        "idle_by_span": spans.idle_by_span(trace, found),
        "idle_in_name": {name: spans.idle_in(trace, [(s.start_us, s.end_us) for s in found if s.name == name])
                         for name in sorted(counts)},
    }


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description="One traced run of a cell, its device idle split by program span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None, help="the window (BENCHMARK.json's run_seconds)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ.setdefault(var, "0")
    bench = run.Bench(run.HERE.parent / "BENCHMARK.json")
    seconds = args.seconds or float(bench.data["run_seconds"])
    with program_spans() as parsed:
        result, _ = run.run_cell(bench, args.workload, args.seed, seconds, True)
    out = {"workload": args.workload, "seed": args.seed, "result": result,
           "spans": report(parsed[-1]) if parsed else None}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
