"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card this process sees.

    python3 -m ffbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the weights and the traffic from ``--seed``, builds the port's
served path (the program's own set-up: int8 quantization on the card,
kernels from ``framefusion_tpu_torch/_build/``), and warms up each frame
count of the mix and the serving loop's captured chunk. The window then
serves the cell's open-loop traffic for ``--seconds`` and drains every
request due in it. With ``--trace 1`` a profiler window covers part of it
and the per-layer metrics are read; otherwise the end-to-end metrics are.
After the window the program's state is freed and ``check.py`` holds a
seeded sample of the served answers against the plain reference. The last
line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.

Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 3 if ``jax``, ``jaxlib``, ``flax`` or
``framefusion_tpu`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "framefusion_tpu")


class Bench:
    """``BENCHMARK.json`` and the data files it names under ``data_dir``."""

    def __init__(self, bench_path: Path, data_dir: Path = HERE):
        self.data = json.loads(Path(bench_path).read_text())
        self.dir = Path(data_dir)

    def _json(self, *parts) -> dict:
        return json.loads((self.dir.joinpath(*parts)).read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in the benchmark")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.dir.parent / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in the benchmark")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def cell(self, workload: str) -> dict:
        return self._json("cells", f"{workload}.json")

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries this cell reports in a run of this kind."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind] if "workloads" not in m or workload in m["workloads"]]

    def reader(self, name: str):
        """``read`` of ``metrics/<name>.py``, or, where there is none, of
        ``metrics/<the name before its first dot>.py``: one reader for a
        quantity split by the cells' end-to-end metrics."""
        path = self.dir / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(f"ffbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class RunView:
    """What a metric reader reads: the window's records, the trace, the cell's files."""

    def __init__(self, *, config, traffic, cell, family, window, tracer, setup_s, end_s):
        self.config, self.traffic, self.cell, self.family = config, traffic, cell, family
        self.window, self.tracer, self.setup_s, self.end_s = window, tracer, setup_s, end_s
        self.trace = tracer.trace

    def _in_trace(self, t) -> bool:
        return (t is not None and self.tracer.opened_at is not None
                and self.tracer.opened_at <= t < self.tracer.closed_at)

    def traced_ingests(self) -> list:
        return [r for r in self.window.records if r.error is None and self._in_trace(r.ingest_s)]

    def traced_admissions(self) -> list:
        return [a for a in self.window.admissions if self._in_trace(a.at_s)]

    def traced_tokens(self) -> int:
        return self.window.trace_tokens[1] - self.window.trace_tokens[0]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def warm_up(program, traffic: dict, seed: int, device):
    """Each frame count of the mix once through ingest and the compressed
    prefill; the pools sized from what those prefills keep; then the loop's
    chunk graph captured and a compaction of its pools run, on requests
    outside the window. Returns (loop, the warm-up's request ids)."""
    import torch

    from . import generator, serve
    from framefusion_tpu_torch.runtime.serving import ServeRequest

    s = traffic["serving"]
    warm = [generator.Request(index=i, due_s=0.0, n_frames=n, drift=sum(traffic["drift"]) / 2,
                              max_new_tokens=min(s["max_new_tokens"], 17 * s["chunk_steps"]),
                              question=traffic["questions"][0])
            for i, n in enumerate(sorted(set(traffic["frames"]["values"])))]
    frames = generator.draw_frames(warm, seed, traffic["frame_shape"], device, generator.STREAM_WARM_UP)
    engine = program.model.engine()
    inputs, longest = [], 0
    for req in warm:
        pixels = serve.preprocess(program, frames[req.index])
        inp = program.pipe.build_inputs(req.question, frames=pixels)
        res = engine.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, patch_num=inp.patch_num,
                             image_token_start=inp.image_token_start, image_token_length=inp.image_token_length,
                             mode="planned")
        longest = max(longest, *(c[2] for c in res.layer_caches))
        log(f"warm-up: {req.n_frames} frames, prompt {inp.input_embeds.shape[0]} tokens, events "
            f"{[(e.layer, e.kind, e.tokens_removed) for e in res.telemetry.events]}, kept {res.valid_len}, "
            f"mode {res.mode}")
        inputs.append(inp)
        del res
    bucket = engine.ff.bucket
    tail_cap = longest + s["prefix_margin"]
    loop = program.model.serving_loop(max_slots=s["slots"], max_new_cap=s["max_new_tokens"],
                                      chunk_steps=s["chunk_steps"], prefill_mode="planned",
                                      prefix_cap=tail_cap + bucket, tail_pool=(1, tail_cap))
    rids = set()
    for req, inp in zip(warm, inputs):
        rids.add(loop.submit(ServeRequest(inp, max_new_tokens=req.max_new_tokens)))
    loop.run()
    while loop.compactions == 0:
        rids.add(loop.submit(ServeRequest(inputs[0], max_new_tokens=warm[0].max_new_tokens)))
        loop.run()
    if device != "cpu":
        torch.cuda.synchronize()
    log(f"warm-up: pools {tuple(loop.k_pool.shape)} + tail {None if loop.k_tail is None else tuple(loop.k_tail.shape)}"
        f", {loop.captures} chunk graph(s), {loop.compactions} compaction(s)")
    return loop, rids


def build(device) -> float:
    """Seconds spent building the program's CUDA kernels and native
    preprocessing library: nonzero only in a checkout's first run, where
    they are part of ``setup_s``; reported apart as ``build_s``."""
    if device == "cpu":
        return 0.0
    from framefusion_tpu_torch import _build, native

    t0 = time.perf_counter()
    _build.build()
    native.load()
    return time.perf_counter() - t0


@dataclasses.dataclass
class Setup:
    config: dict
    traffic: dict
    cell: dict
    family: object
    program: object
    loop: object
    warm_rids: set


def prepare(bench: Bench, workload: str, seed: int, device: str) -> Setup:
    """The cell's program built from the seed, warmed up, its loop ready."""
    from . import families

    wl = bench.workload(workload)
    config, traffic, cell = bench.config(wl["config"]), bench.traffic(wl["traffic"]), bench.cell(workload)
    family = families.load(config["kind"])
    program = family.build(config, seed, device)
    loop, warm_rids = warm_up(program, traffic, seed, device)
    return Setup(config, traffic, cell, family, program, loop, warm_rids)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault=None, control: bool = False, drain_limit_s: float = 240.0) -> tuple:
    """One run of a cell. Returns (result dict, checks dict). ``fault``, for
    tests, is called with the program and the loop before the window and
    may break the timed path. ``control`` also reads the control (the
    reference a precision down) on the same sample, into the checks. A
    request not answered ``drain_limit_s`` after the window closed is
    unfinished."""
    import torch

    from . import check, generator, serve, tracing

    build_s = build(device)
    st = prepare(bench, workload, seed, device)
    config, traffic, cell, family, program, loop = st.config, st.traffic, st.cell, st.family, st.program, st.loop
    requests = generator.schedule(traffic, cell["rate_rps"], seconds, seed)
    frames = generator.draw_frames(requests, seed, traffic["frame_shape"], device)
    keep = set(generator.check_sample(requests, traffic["check_requests"], seed))
    if fault is not None:
        fault(program, loop)
    traced = min(float(traffic["trace_seconds"]), seconds)
    tracer = tracing.Tracer(trace, start_s=(seconds - traced) / 2, seconds=traced)
    tracer.warm_up()
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.2f} s (builds {build_s:.2f} s); {len(requests)} requests due in the {seconds} s window, check sample {sorted(keep)}")

    window = serve.run(program, loop, requests, frames, seconds, tracer, keep, on_card, st.warm_rids,
                       drain_limit_s=drain_limit_s)
    end_s = max([r.done_s or 0.0 for r in window.records] + [window.seconds])
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    tracer.finish()
    view = RunView(config=config, traffic=traffic, cell=cell, family=family, window=window, tracer=tracer,
                   setup_s=setup_s, end_s=end_s)
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    unfinished = sum(1 for r in window.records if r.error is not None or r.tokens is None)
    short = sum(1 for r in window.records if r.tokens is not None and len(r.tokens) != r.max_new_tokens)
    for r in window.records:
        if r.error is not None:
            log(f"request {r.index} failed: {r.error}")
    log("requests (index, frames, budget, due, ingest, submit, done): " + json.dumps(
        [[r.index, r.n_frames, r.max_new_tokens] + [None if t is None else round(t, 4)
                                                   for t in (r.due_s, r.ingest_s, r.submit_s, r.done_s)]
         for r in window.records]))
    samples = [check.Sample(request=requests[i], frames=frames[i], pixels=window.kept[i].pixels,
                            features=window.kept[i].features, tokens=window.records[i].tokens,
                            events=window.kept[i].events)
               for i in sorted(keep) if i in window.kept and window.records[i].tokens]
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace and tracer.trace is not None:
        device_info.update(busy_s=tracer.trace.busy_s(), window_s=tracer.trace.window_s)
        breakdown = tracer.trace.breakdown()
    log(f"window {window.seconds:.3f} s, {len(window.records)} requests, {window.tokens} answer tokens, "
        f"{len(window.admissions)} admissions, {unfinished} unfinished, {short} short")

    # The program's state goes before the reference runs.
    del program, loop, view, st
    tracer.trace = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.readings(config, seed, samples, device, control=control)
    log(f"reference over {len(samples)} requests, {sum(len(s.tokens) for s in samples)} served tokens: "
        f"{time.perf_counter() - t_check:.1f} s; program events differ from the reference's in "
        f"{values['events_differ']}")
    correct, checks = check.judge(values, cell.get("limits", {}), unfinished, short)
    if control:
        checks.update({k: {"value": v, "limit": None} for k, v in values.items() if k.startswith("control.")})
    result = {"correct": correct, "attempted": len(window.records), "failed": unfinished,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["build_s"] = build_s
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Libraries that would load JAX by themselves are kept from it.
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ.setdefault(var, "0")
    bench = Bench(HERE.parent / "BENCHMARK.json")
    chips = bench.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"ffbench: the cell needs {chips} CUDA card(s); this process sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"ffbench: forbidden modules loaded: {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
