"""Window statistics: nearest-rank percentiles over every request due, and rates."""

from __future__ import annotations

import math


def nearest_rank(values, p: float) -> float:
    """The ``p``-th percentile by nearest rank: the ceil(p / 100 * n)-th
    smallest value (1-based)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(1, math.ceil(p / 100.0 * len(vals))) - 1]


def latencies_s(records, end_s: float) -> list:
    """Each due request's seconds from its due time to its answer on the
    host. A request that failed or never finished counts as still waiting
    at ``end_s``, the end of the run, above every served one."""
    out = []
    for r in records:
        done = r.done_s if (r.error is None and r.done_s is not None) else max(end_s, r.due_s)
        out.append(done - r.due_s)
    return out


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than zero")
    return count / seconds
