"""The program's spans in the benchmark's trace (``ffbench/spans.py``) and the readers of them.

A synthetic Chrome trace holds the harness's ranges, the program's
``framefusion.*`` spans and device operations with their launches. On it:
the harness's parse hands the program's spans to the trace as
``spans.parse_events`` reads them; each span reader reads its
hand-computed value; ``idle_in`` agrees with ``busy_intervals()``; and the
trace, with every other per-layer reader and ``breakdown()``, reads the
same with the program's spans in the file and without them.
"""

import dataclasses
import json
import types

import pytest

from ffbench import families, run, serve, span_report, spans, tracing
from ffbench.tests import tiny

SEED = 2**31 + 7
T0 = 1000.0  # the window opens here, in microseconds


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": T0 + ts, "dur": dur, "args": args}


def launch(corr, ts, graph=False):
    return X("cuda_runtime", "cudaGraphLaunch" if graph else "cudaLaunchKernel", ts, 2, correlation=corr)


def kernel(corr, name, ts, dur):
    return X("kernel", name, ts, dur, correlation=corr)


HARNESS = [
    X("user_annotation", "ffbench.window", 0, 1000),
    X("user_annotation", "ffbench.encode", 20, 70),
    X("user_annotation", "ffbench.submit", 90, 5),
    X("user_annotation", "ffbench.step", 100, 400),
    X("user_annotation", "ffbench.step", 520, 460),
]
DEVICE = [
    launch(1, 25), kernel(1, "bidir_attn_fwd", 30, 30),  # the tower, under encode
    launch(2, 105), kernel(2, "flash_attn_fwd", 110, 30),  # admission 0's prefill
    launch(3, 280, graph=True), kernel(3, "rows_kernel", 300, 100),  # chunk 1's replay
    launch(4, 590), kernel(4, "flash_attn_fwd", 600, 50),  # admission 1's prefill
    launch(5, 850, graph=True), kernel(5, "rows_kernel", 900, 50),  # chunk 2's replay
]
# Request 1 was submitted before the window opened; request 0's planned
# prefill falls back to the fused executor.
PROGRAM = [
    X("user_annotation", "framefusion.serve.submit#1", -50, 1),
    X("user_annotation", "framefusion.serve.submit#0", 91, 1),
    X("user_annotation", "framefusion.serve.step", 101, 398),
    X("user_annotation", "framefusion.serve.admit#0", 102, 158),
    X("user_annotation", "framefusion.engine.prefill", 103, 152),
    X("user_annotation", "framefusion.engine.fallback", 150, 100),
    X("user_annotation", "framefusion.serve.splice", 256, 3),
    X("user_annotation", "framefusion.serve.chunk#1", 262, 236),
    X("user_annotation", "framefusion.serve.upload", 263, 7),
    X("user_annotation", "framefusion.serve.replay", 271, 149),
    X("user_annotation", "framefusion.serve.read", 421, 19),
    X("user_annotation", "framefusion.serve.retire#0", 441, 9),
    X("user_annotation", "framefusion.serve.step", 521, 458),
    X("user_annotation", "framefusion.serve.admit#1", 522, 198),
    X("user_annotation", "framefusion.engine.prefill", 523, 190),
    X("user_annotation", "framefusion.serve.chunk#1", 722, 253),
    X("user_annotation", "framefusion.serve.replay", 800, 160),
]

# Busy: [30, 60], [110, 140], [300, 400], [600, 650], [900, 950] (+ T0).
ADMIT_IDLE_US = [(260 - 102) - 30, (720 - 522) - 50]
CHUNK_IDLE_US = [(498 - 262) - 100, (975 - 722) - 50]


def _parse(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse_chrome_trace(str(path)), spans.parse_events(events)


@pytest.fixture
def traced(tmp_path):
    trace, found = _parse(tmp_path, HARNESS + DEVICE + PROGRAM)
    assert trace.spans == found
    return trace


def _view(trace):
    return types.SimpleNamespace(trace=trace)


def test_span_names_and_ids_are_read_from_the_event_names(traced):
    names = [(s.name, s.n) for s in traced.spans]
    assert names[:3] == [("serve.submit", 1), ("serve.submit", 0), ("serve.step", None)]
    assert ("serve.chunk", 1) in names and len(names) == len(PROGRAM)
    assert all(s.end_us >= s.start_us for s in traced.spans)


@pytest.mark.parametrize("name,want", [
    ("admit_idle_ms.qa", sum(ADMIT_IDLE_US) / 2 * 1e-3),
    ("chunk_idle_ms.qa", sum(CHUNK_IDLE_US) / 2 * 1e-3),
    ("chunk_idle_ms.captions", sum(CHUNK_IDLE_US) / 2 * 1e-3),
    ("prefill_fallback_pct.qa", 50.0),
])
def test_each_span_reader_reads_its_hand_computed_value(traced, name, want):
    bench = run.Bench(tiny.REPO / "BENCHMARK.json")
    assert bench.reader(name)(_view(traced)) == pytest.approx(want, rel=1e-9)
    # the report's traced queue wait: request 0 only, request 1's submit is before the window
    assert spans.queue_wait_ms(traced, traced.spans) == pytest.approx((102 - 92) * 1e-3, rel=1e-9)


@pytest.mark.parametrize("opened_at,want_ms", [(0.5, (0.02 + 0.1) / 2 * 1e3), (None, (0.02 + 0.3 + 0.1) / 3 * 1e3),
                                               (0.05, None)])
def test_queue_wait_reads_the_loops_host_waits_admitted_before_the_trace(opened_at, want_ms):
    """``queue_wait_ms.qa`` is the mean of the loop's ``wait_s`` over the
    requests whose admission started before the traced window opened (all
    of them without one); a request not retired has no wait."""
    recs = [serve.Record(i, 0.0, 16, 8, submit_s=sub, wait_s=wait)
            for i, (sub, wait) in enumerate([(0.1, 0.02), (0.3, 0.3), (0.35, None), (0.2, 0.1)])]
    view = types.SimpleNamespace(window=types.SimpleNamespace(records=recs), tracer=types.SimpleNamespace(opened_at=opened_at))
    got = run.Bench(tiny.REPO / "BENCHMARK.json").reader("queue_wait_ms.qa")(view)
    assert got == (None if want_ms is None else pytest.approx(want_ms, rel=1e-12))


@pytest.mark.parametrize("name", ["admit_idle_ms.qa", "chunk_idle_ms.qa", "prefill_fallback_pct.qa"])
def test_span_readers_read_nothing_without_the_program_spans(tmp_path, name):
    trace, found = _parse(tmp_path, HARNESS + DEVICE)
    assert found == [] and trace.spans == []
    reader = run.Bench(tiny.REPO / "BENCHMARK.json").reader(name)
    assert reader(_view(trace)) is None
    assert reader(_view(None)) is None


def test_idle_in_agrees_with_busy_intervals(traced):
    lo, hi = traced.window_us
    idle = traced.window_s - traced.busy_s()
    assert spans.idle_in(traced, [(lo, hi)]) == pytest.approx(idle, rel=1e-12)
    # intervals past the window's edges are clipped; overlaps count once
    assert spans.idle_in(traced, [(lo - 500, lo + 400), (lo + 200, hi + 900)]) == pytest.approx(idle, rel=1e-12)
    a, b = (lo + 102, lo + 260), (lo + 200, lo + 480)
    union = spans.idle_in(traced, [(lo + 102, lo + 480)])
    assert spans.idle_in(traced, [a, b]) == pytest.approx(union, rel=1e-12)
    assert union == pytest.approx((480 - 102 - 30 - 100) * 1e-6, rel=1e-12)
    # disjoint pieces add up; a busy stretch reads zero
    assert spans.idle_in(traced, [(lo, lo + 500)]) + spans.idle_in(traced, [(lo + 500, hi)]) == pytest.approx(idle)
    assert spans.idle_in(traced, [(lo + 300, lo + 400)]) == 0.0


def test_idle_by_span_splits_the_whole_idle_time(traced):
    by = spans.idle_by_span(traced, traced.spans)
    assert sum(by.values()) == pytest.approx(traced.window_s - traced.busy_s(), rel=1e-12)
    assert by["engine.fallback"] == pytest.approx((250 - 150) * 1e-6)
    assert by["serve.replay"] == pytest.approx((420 - 271 - 100 + 960 - 800 - 50) * 1e-6)
    assert by["ffbench:encode"] == pytest.approx((90 - 20 - 30) * 1e-6)
    cover = spans.step_coverage(traced, traced.spans)
    step_idle = (400 - 30 - 100) + (460 - 50 - 50)
    assert cover["step_idle_s"] == pytest.approx(step_idle * 1e-6)
    assert cover["covered_s"] == pytest.approx((sum(ADMIT_IDLE_US) + sum(CHUNK_IDLE_US)) * 1e-6)
    assert cover["share"] == pytest.approx(cover["covered_s"] / cover["step_idle_s"])


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _run_view(trace, config_name):
    """A RunView over ``trace`` with a window of two requests ingested and
    admitted while the profiler was open."""
    bench = run.Bench(tiny.REPO / "BENCHMARK.json")
    config = bench.config(config_name)
    records = [serve.Record(i, 0.1 * i, 16, 8, ingest_s=0.5 + 0.1 * i, submit_s=0.6 + 0.1 * i,
                            preprocess_s=0.02, encode_events=(_Event(1.0), _Event(4.5 + i)), rid=i,
                            done_s=2.0 + i, tokens=[1] * 8, prompt_len=3000) for i in range(2)]
    window = serve.Window(records=records, admissions=[serve.Admission(0.7, 3000, []),
                                                       serve.Admission(0.8, 3100, [])],
                          seconds=3.0, tokens=16, kept={}, trace_tokens=(3, 11))
    tracer = types.SimpleNamespace(trace=trace, opened_at=0.4, closed_at=1.4, counted=None)
    return run.RunView(config=config, traffic={}, cell={}, family=families.load(config["kind"]), window=window,
                       tracer=tracer, setup_s=12.0, end_s=4.0)


@pytest.mark.parametrize("config_name", ["llava-video-7b-qwen2", "internvl2.5-8b"])
def test_existing_readers_and_breakdown_ignore_the_program_spans(tmp_path, config_name):
    with_spans, found = _parse(tmp_path, HARNESS + DEVICE + PROGRAM, "with.json")
    without, _ = _parse(tmp_path, HARNESS + DEVICE, "without.json")
    assert found and with_spans.spans == found and dataclasses.replace(with_spans, spans=[]) == without
    assert json.dumps(with_spans.breakdown()) == json.dumps(without.breakdown())
    bench = run.Bench(tiny.REPO / "BENCHMARK.json")
    existing = [m["name"] for m in bench.data["per_layer"] if m["name"] not in
                ("admit_idle_ms.qa", "queue_wait_ms.qa", "prefill_fallback_pct.qa")]
    assert len(existing) == 10
    read_some = 0
    for name in existing:
        reader = bench.reader(name)
        got, want = reader(_run_view(with_spans, config_name)), reader(_run_view(without, config_name))
        assert repr(got) == repr(want), name
        read_some += got is not None
    assert read_some == len(existing)


def test_a_traced_cpu_run_reads_the_span_metrics(tmp_path):
    """The tiny benchmark on the CPU, traced: the harness's own parse hands
    the program's spans to the trace, the span entries of ``BENCHMARK.json``
    and the host queue wait read, and the report on that same trace
    (``span_report.parsed_traces``) splits the whole idle time."""
    bench = tiny.make_bench(tmp_path)
    names = [m["name"] for m in bench.metrics("llava7b.qa", trace=True) if m["source"] == "program_span"]
    assert sorted(names) == ["admit_idle_ms.qa", "prefill_fallback_pct.qa"]
    parse = tracing.parse_chrome_trace
    with span_report.parsed_traces() as parsed:
        result, _ = run.run_cell(bench, "llava7b.qa", SEED, 3.0, True, device="cpu")
    assert tracing.parse_chrome_trace is parse and len(parsed) == 1
    got = {n: result["metrics"][n]["value"] for n in names + ["queue_wait_ms.qa"] if n in result["metrics"]}
    assert set(got) == {"admit_idle_ms.qa", "prefill_fallback_pct.qa", "queue_wait_ms.qa"}, got
    assert got["admit_idle_ms.qa"] > 0 and 0 <= got["prefill_fallback_pct.qa"] <= 100 and got["queue_wait_ms.qa"] >= 0
    rep = span_report.report(parsed[0])
    assert sum(rep["idle_by_span"].values()) == pytest.approx(rep["window_s"] - rep["busy_s"], rel=1e-9)
    assert rep["admissions"] > 0 and rep["chunks"] > 0 and rep["step_coverage"]["share"] > 0
    assert json.loads(json.dumps(rep, allow_nan=False)) == rep


def test_a_recorded_trace_carries_the_program_spans(tmp_path):
    """A trace the profiler records holds the harness's window and the
    program's spans, a request id among them: the harness's parse keeps the
    same spans that ``spans.parse_events`` reads from its events."""
    import torch

    from framefusion_tpu_torch.runtime import profiling

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            with profiling.span("serve.step"), profiling.span("serve.admit", 7):
                torch.ones(64).sum()
            with profiling.span("serve.chunk", 2):
                torch.ones(64).sum()
    path = tmp_path / "recorded.json"
    prof.export_chrome_trace(str(path))
    trace = tracing.parse_chrome_trace(str(path))
    assert trace.spans == spans.parse_events(json.loads(path.read_text())["traceEvents"])
    assert [(s.name, s.n) for s in trace.spans] == [("serve.step", None), ("serve.admit", 7), ("serve.chunk", 2)]
