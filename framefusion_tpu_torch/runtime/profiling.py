"""Profiling and timing helpers (port of ``framefusion_tpu.runtime.profiling``).

``trace`` records what runs inside it with ``torch.profiler`` (host
operations, and the card's kernels and copies where there is a card) and
writes a Chrome trace that Perfetto (ui.perfetto.dev) and chrome://tracing
open. ``span`` marks the program's own stages in that trace (and in any
other ``torch.profiler`` window the caller opens): the serving loop, the
compressed prefill, ingest and the checkpoint load; with no profiler
recording it costs one check. ``elapsed`` is the port's timer (CUDA events
on the card, the host clock on the CPU); ``timeit``,
``scripts.common.DeviceTimer`` and ``kernel_bench.events_time_ms`` time
through it. ``force`` waits for the card and reads one scalar back.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

SPAN_PREFIX = "framefusion."
_NO_SPAN = contextlib.nullcontext()


def span(name: str, n: int | None = None):
    """A named range of the program's host time in the profiler's timeline:
    ``with span("serve.admit", rid): ...`` records
    ``framefusion.serve.admit#<rid>`` as a ``user_annotation`` event, on the
    clock of the card's kernels. ``n`` (a request id, a count) goes into the
    name after ``#``: the Chrome trace exports no other attribute of a
    range. With no profiler recording, returns one shared no-op context and
    formats nothing. Not for code a CUDA graph captures: a replay records no
    host range."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name + ("" if n is None else f"#{n}"))


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Trace a block: ``with profiling.trace(d): engine.prefill(...)``.

    Writes ``trace-<time>-<pid>.json`` into ``log_dir`` (made if missing; a
    ``framefusion_trace`` folder of the temporary directory by default) and
    yields ``log_dir``.
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "framefusion_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))


def force(x) -> float:
    """Wait for ``x``: synchronize its card, then read one scalar (its fp32
    sum) back to the host."""
    x = torch.as_tensor(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.float().sum())


def elapsed(fn, on_card: bool, reps: int = 1):
    """``(seconds a call, last output)`` of ``reps`` calls of ``fn()`` queued
    back to back: the port's timer. On the card, CUDA events on the current
    stream bracket the calls, after the stream has finished what it had;
    on the CPU, the host clock does."""
    if on_card:
        stream = torch.cuda.current_stream()
        stream.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            out = fn()
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) / reps, out


def timeit(fn, probe=lambda o: o, reps: int = 3, warmup: bool = True):
    """JAX's contract: ``(seconds a call, last output)``: ``fn()`` once
    (forced, when ``warmup``), then ``reps`` calls queued back to back,
    timed by ``elapsed`` on the device of ``probe(output)``."""
    out = fn()
    if warmup:
        force(probe(out))
    return elapsed(fn, torch.as_tensor(probe(out)).is_cuda, reps)
