"""The program's own spans in the benchmark's trace, and the device idle they cover.

The port marks its stages with ``torch.profiler`` ranges named
``framefusion.<name>`` or ``framefusion.<name>#<n>`` (``n`` a request id or
a count): the serving loop's submit, step, admission, splice and chunk
(compaction, capture, upload, replay, read, retire), the compressed
prefill's stages and ingest. They land in the same Chrome trace as the
device's operations and the harness's ``ffbench.*`` ranges, on one clock,
so each idle gap of the device can be put against what the host was doing.

``parse_events`` reads them from a trace's events; ``idle_in`` is the
device idle inside host intervals. The functions below it compute the
per-layer readings from a ``tracing.Trace`` and its spans; each returns
None where it has nothing to count (a program without the spans among
them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PREFIX = "framefusion."


@dataclasses.dataclass(frozen=True)
class Span:
    name: str  # without the prefix and the ``#n`` suffix
    n: Optional[int]
    start_us: float
    end_us: float


def parse_events(events) -> list:
    """The program's spans among a Chrome trace's ``traceEvents``, by start."""
    out = []
    for ev in events:
        name = ev.get("name", "")
        if ev.get("ph") != "X" or ev.get("cat") != "user_annotation" or not name.startswith(PREFIX):
            continue
        base, _, n = name[len(PREFIX):].partition("#")
        t0 = float(ev["ts"])
        out.append(Span(base, int(n) if n.lstrip("-").isdigit() else None, t0, t0 + float(ev.get("dur", 0.0))))
    out.sort(key=lambda s: (s.start_us, -s.end_us))
    return out


def _merge(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _intersect(a: list, b: list) -> list:
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: list, b: list) -> list:
    """The parts of the sorted disjoint intervals ``a`` outside those of ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def _clipped(trace, intervals) -> list:
    lo, hi = trace.window_us
    return _merge((max(s, lo), min(e, hi)) for s, e in intervals)


def idle_in(trace, intervals) -> float:
    """Seconds of the traced window in which the device was idle (no
    interval of ``trace.busy_intervals()``) and some of the given host
    intervals (start_us, end_us) was open; overlapping intervals count once."""
    host = _clipped(trace, intervals)
    return (sum(e - s for s, e in host) - _overlap_us(host, trace.busy_intervals())) * 1e-6


def started_in_window(trace, spans, name: str) -> list:
    lo, hi = trace.window_us
    return [s for s in spans if s.name == name and lo <= s.start_us < hi]


def idle_ms_per_span(trace, spans, name: str) -> Optional[float]:
    """Device idle inside the ``name`` spans that start in the window, in
    milliseconds a span."""
    chosen = started_in_window(trace, spans, name)
    if not chosen:
        return None
    return 1e3 * idle_in(trace, [(s.start_us, s.end_us) for s in chosen]) / len(chosen)


def queue_wait_ms(trace, spans) -> Optional[float]:
    """Mean milliseconds from a request's ``serve.submit`` end to its
    ``serve.admit`` start, over the requests admitted in the window whose
    submit started in it too."""
    lo, hi = trace.window_us
    submitted = {s.n: s for s in spans if s.name == "serve.submit" and lo <= s.start_us < hi}
    waits = [(a.start_us - submitted[a.n].end_us) * 1e-3 for a in started_in_window(trace, spans, "serve.admit")
             if a.n in submitted]
    return sum(waits) / len(waits) if waits else None


def fallback_pct(trace, spans) -> Optional[float]:
    """Share of the admissions that start in the window whose planned
    prefill fell back and ran a second time, fused (an ``engine.fallback``
    span inside the ``serve.admit`` span)."""
    admits = started_in_window(trace, spans, "serve.admit")
    if not admits:
        return None
    fallbacks = [s for s in spans if s.name == "engine.fallback"]
    hit = sum(1 for a in admits if any(a.start_us <= f.start_us and f.end_us <= a.end_us for f in fallbacks))
    return 100.0 * hit / len(admits)


def innermost(spans) -> list:
    """The host timeline as (start_us, end_us, name) segments, each named
    by the innermost program span open over it (spans of one thread nest)."""
    ordered = sorted(spans, key=lambda s: (s.start_us, -s.end_us))
    points = sorted({t for s in ordered for t in (s.start_us, s.end_us)})
    out, stack, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(ordered) and ordered[i].start_us <= a:
            while stack and stack[-1].end_us <= ordered[i].start_us:
                stack.pop()
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1].end_us <= a:
            stack.pop()
        if stack:
            if out and out[-1][2] == stack[-1].name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, out[-1][2])
            else:
                out.append((a, b, stack[-1].name))
    return out


def idle_by_span(trace, spans) -> dict:
    """Device idle seconds of the window by the innermost program span the
    host was in; idle outside every program span goes under the harness
    range open then, as ``ffbench:<range>`` (``ffbench:other`` outside
    them all)."""
    lo, hi = trace.window_us
    busy = trace.busy_intervals()
    gaps = []
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    for k in range(0, len(edges), 2):
        if edges[k + 1] > edges[k]:
            gaps.append([edges[k], edges[k + 1]])
    segments = [(max(a, lo), min(b, hi), name) for a, b, name in innermost(spans) if min(b, hi) > max(a, lo)]
    out: dict = {}
    covered = []
    i = j = 0
    while i < len(segments) and j < len(gaps):
        (a, b, name), (s, e) = segments[i], gaps[j]
        x, y = max(a, s), min(b, e)
        if y > x:
            out[name] = out.get(name, 0.0) + (y - x) * 1e-6
            covered.append([x, y])
        if b < e:
            i += 1
        else:
            j += 1
    uncovered = _subtract(gaps, _merge(covered))
    left = sum(e - s for s, e in uncovered)
    for name in sorted({r[0] for r in trace.ranges}):
        secs = _overlap_us(uncovered, _merge((s, e) for n, s, e in trace.ranges if n == name))
        if secs > 0:
            out["ffbench:" + name] = secs * 1e-6
            left -= secs
    if left > 0:
        out["ffbench:other"] = left * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def step_coverage(trace, spans) -> dict:
    """Device idle under the harness's ``ffbench.step`` ranges, and the part
    of it that the program's ``serve.admit`` and ``serve.chunk`` spans cover."""
    steps = _clipped(trace, [(s, e) for name, s, e in trace.ranges if name == "step"])
    mine = _clipped(trace, [(s.start_us, s.end_us) for s in spans if s.name in ("serve.admit", "serve.chunk")])
    step_idle = idle_in(trace, steps)
    covered = idle_in(trace, _intersect(steps, mine))
    return {"step_idle_s": step_idle, "covered_s": covered,
            "share": covered / step_idle if step_idle > 0 else None}
