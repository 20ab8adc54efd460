"""The benchmark's own trace: a ``torch.profiler`` window over part of the run.

The harness puts ``record_function`` ranges named ``ffbench.<what>`` around
the calls it makes into the program (preprocessing, the tower, each step of
the serving loop, the waits for the next arrival). The profiler's Chrome
trace is read back into ``Trace``: the device's operations (kernels, copies,
fills), each attributed to the host range that launched it through the
profiler's correlation ids, and told apart as a graph replay's when its
launch was a ``cudaGraphLaunch``. The trace file lives in the run's
temporary directory and is deleted once read.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

PREFIX = "ffbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start_us: float
    dur_us: float
    range: str  # the ffbench range whose host time holds the launch ("" if none)
    graph: bool  # launched by a cudaGraphLaunch (a replayed captured graph)


@dataclasses.dataclass
class Trace:
    ops: list  # DeviceOp, sorted by start
    ranges: list  # (name, start_us, end_us) of the harness's ranges, sorted
    window_us: tuple  # (start, end) of the traced window
    graph_launches: int  # cudaGraphLaunch calls in the window

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_intervals(self) -> list:
        """Merged (start, end) intervals in which some device op ran, clipped to the window."""
        lo, hi = self.window_us
        spans = sorted((max(o.start_us, lo), min(o.start_us + o.dur_us, hi)) for o in self.ops)
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, pred) -> float:
        return sum(o.dur_us for o in self.ops if pred(o)) * 1e-6

    def host_range_at(self, t_us: float) -> str:
        starts = [r[1] for r in self.ranges]
        i = bisect.bisect_right(starts, t_us) - 1
        if i >= 0 and self.ranges[i][1] <= t_us < self.ranges[i][2]:
            return self.ranges[i][0]
        return "other"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time between
        them by the harness range the host was in when each gap opened."""
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur_us * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: dict = {}
        busy = self.busy_intervals()
        edges = [self.window_us[0]] + [x for s, e in busy for x in (s, e)] + [self.window_us[1]]
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 > g0:
                name = self.host_range_at(g0)
                gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


def parse_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, ranges, window = {}, [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (name, float(ev["ts"]))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            t0 = float(ev["ts"])
            if name == PREFIX + "window":
                window = (t0, t0 + float(ev["dur"]))
            else:
                ranges.append((name[len(PREFIX):], t0, t0 + float(ev["dur"])))
    ranges.sort(key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    graph_launches = sum(1 for n, _ in launches.values() if "GraphLaunch" in n)
    ops = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        where, graph = "", False
        if launch is not None:
            graph = "GraphLaunch" in launch[0]
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and ranges[i][1] <= launch[1] <= ranges[i][2]:
                where = ranges[i][0]
        ops.append(DeviceOp(ev.get("name", ""), ev["cat"], float(ev["ts"]), float(ev.get("dur", 0.0)), where, graph))
    ops.sort(key=lambda o: o.start_us)
    if window is None:
        raise RuntimeError("the trace holds no ffbench.window range")
    return Trace(ops=ops, ranges=ranges, window_us=window, graph_launches=graph_launches)


class Tracer:
    """Ranges around the harness's calls, and a profiler window over
    [start_s, start_s + seconds) of the run's clock. Without tracing, the
    ranges are no-ops."""

    def __init__(self, enabled: bool, start_s: float = 0.0, seconds: float = 0.0):
        self.enabled, self.start_s, self.stop_s = enabled, start_s, start_s + seconds
        self.prof = None
        self.window_cm = None
        self.trace = None
        self.opened_at = self.closed_at = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def warm_up(self) -> None:
        """A short profile during set-up, so that the window's start does not
        pay the profiler's first initialisation."""
        if not self.enabled:
            return
        import torch

        with torch.profiler.profile(activities=_activities()):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def tick(self, now_s: float) -> None:
        """Open or close the profiler window as the run's clock passes its edges."""
        if not self.enabled:
            return
        if self.prof is None and self.opened_at is None and now_s >= self.start_s:
            import torch

            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.start()
            self.window_cm = torch.profiler.record_function(PREFIX + "window")
            self.window_cm.__enter__()
            self.opened_at = now_s
        elif self.prof is not None and self.closed_at is None and now_s >= self.stop_s:
            self.close(now_s)

    def close(self, now_s: float) -> None:
        if self.prof is None or self.closed_at is not None:
            return
        import torch

        self.window_cm.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.closed_at = now_s

    def finish(self) -> None:
        """Read the closed window's trace back (after the measured window:
        the export and the parse take seconds)."""
        if self.prof is None or self.closed_at is None:
            return
        fd, path = tempfile.mkstemp(prefix="ffbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.prof = None
            self.trace = parse_chrome_trace(path)
        finally:
            os.unlink(path)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
