"""The served path driven from outside, open loop, as a user's requests travel it.

Each request, at its due time: the host preprocessing the pipeline itself
runs (``preprocess.preprocess_frames(..., impl="native")``), then
``TextPipeline.build_inputs`` on those pixels (tower, projector, prompt on
the card), then ``ServingLoop.submit``. Between arrivals the loop steps:
admissions run the engine's compressed prefill, chunks replay the captured
decode graph. One host thread does all of it, as one server process would.
The arrival loop follows ``framefusion_tpu_torch/scripts/example_serving.py``'s
``run_loop``; here a request's time starts at its due time.

A request's latency is its retirement on the host (the loop stamps it
after the chunk's device read) less its due time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Record:
    index: int
    due_s: float
    n_frames: int
    max_new_tokens: int
    ingest_s: Optional[float] = None  # when its ingest began, on the window's clock
    submit_s: Optional[float] = None  # when the loop queued it
    preprocess_s: float = 0.0  # host seconds in preprocess_frames
    encode_events: Optional[tuple] = None  # CUDA events around build_inputs (traced runs)
    rid: Optional[int] = None
    done_s: Optional[float] = None  # retirement, on the window's clock
    tokens: Optional[list] = None
    prompt_len: int = 0
    error: Optional[str] = None
    wait_s: Optional[float] = None  # the loop's host seconds from submit to its admission's start


@dataclasses.dataclass
class Admission:
    at_s: float  # on the window's clock
    prompt_len: int
    events: list  # [(layer, kind, tokens_removed)] of the program's telemetry


@dataclasses.dataclass
class Kept:
    """What the output check reads of a sampled request: the program's
    pixels and video tokens, as the timed path made them."""

    pixels: np.ndarray
    features: object  # the prompt's image rows, (n, D) fp32 on the card
    events: Optional[list] = None


def preprocess(program, frames):
    from framefusion_tpu_torch import preprocess as pp

    size = program.image_size
    return pp.preprocess_frames(frames, program.port_family, target=(size, size), impl="native")


def ingest(program, loop, req, frames, tracer, on_card: bool, keep: bool):
    """Preprocess, encode and submit one request. Returns (rid, submit
    time (perf_counter), prompt length, preprocess seconds, encode events,
    kept outputs)."""
    import torch

    from framefusion_tpu_torch.runtime.serving import ServeRequest

    t0 = time.perf_counter()
    with tracer.range("preprocess"):
        pixels = preprocess(program, frames)
    pre_s = time.perf_counter() - t0
    events = None
    if tracer.enabled and on_card:
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    with tracer.range("encode"):
        inputs = program.pipe.build_inputs(req.question, frames=pixels)
    if events is not None:
        events[1].record()
    kept = None
    if keep:
        rows = torch.as_tensor(np.asarray(inputs.patch_type) >= 0, device=inputs.input_embeds.device)
        kept = Kept(pixels=pixels, features=inputs.input_embeds[rows].clone())
    with tracer.range("submit"):
        submitted = time.perf_counter()
        rid = loop.submit(ServeRequest(inputs, max_new_tokens=req.max_new_tokens))
    return rid, submitted, int(inputs.input_embeds.shape[0]), pre_s, events, kept


class AdmissionLog:
    """Wraps the engine's ``prefill`` to note each admission's time, length
    and compression events (host values the program already holds)."""

    def __init__(self, engine, clock):
        self.engine, self.clock, self.log = engine, clock, []
        self._orig = engine.prefill

        def prefill(*args, **kwargs):
            result = self._orig(*args, **kwargs)
            tel = result.telemetry
            events = [] if tel is None else [(e.layer, e.kind, int(e.tokens_removed)) for e in tel.events]
            self.log.append(Admission(at_s=self.clock(), prompt_len=int(args[0].shape[0]), events=events))
            return result

        engine.prefill = prefill

    def close(self) -> None:
        self.engine.__dict__.pop("prefill", None)


def tokens_read(loop, skip_rids: set) -> int:
    """Answer tokens the host has read back: retired answers and the
    emitted counts of the slots still decoding."""
    retired = sum(len(r.tokens) for rid, r in loop._results.items() if rid not in skip_rids)
    return retired + int(np.sum(loop.emitted[loop.active]))


@dataclasses.dataclass
class Window:
    records: list
    admissions: list
    seconds: float  # the window's actual length on the host clock (its last chunk included)
    tokens: int  # answer tokens read back within it
    kept: dict  # request index -> Kept
    trace_tokens: tuple = (0, 0)  # tokens read back at the traced window's edges


def run(program, loop, requests: list, frames: dict, seconds: float, tracer, keep: set, on_card: bool,
        skip_rids: set, drain_limit_s: float = 240.0) -> Window:
    """Serve ``requests`` (due times on the window's clock), then drain
    every one of them. The window closes at the first chunk boundary at or
    past ``seconds``."""
    import torch

    t0 = time.perf_counter()

    def clock():
        return time.perf_counter() - t0

    admissions = AdmissionLog(loop.engine, clock)
    records = [Record(r.index, r.due_s, r.n_frames, r.max_new_tokens) for r in requests]
    in_flight, kept = {}, {}
    nxt, closed = 0, None
    trace_edges = {}
    while True:
        now = clock()
        tracer.tick(now)
        if tracer.opened_at is not None and "open" not in trace_edges:
            trace_edges["open"] = tokens_read(loop, skip_rids)
        if tracer.closed_at is not None and "close" not in trace_edges:
            trace_edges["close"] = tokens_read(loop, skip_rids)
        if closed is None and now >= seconds:
            closed = (now, tokens_read(loop, skip_rids))
        while nxt < len(requests) and requests[nxt].due_s <= now:
            req, rec = requests[nxt], records[nxt]
            rec.ingest_s = now
            try:
                rid, submitted, rec.prompt_len, rec.preprocess_s, rec.encode_events, k = ingest(
                    program, loop, req, frames[req.index], tracer, on_card, req.index in keep)
                rec.submit_s = submitted - t0
            except (ValueError, RuntimeError) as exc:  # a request the program refuses fails; the run goes on
                rec.error = f"{type(exc).__name__}: {exc}"
            else:
                rec.rid = rid
                in_flight[rid] = rec
                if k is not None:
                    kept[req.index] = k
            nxt += 1
            now = clock()
        if in_flight:
            with tracer.range("step"):
                loop.step()
            for rid in list(in_flight):
                res = loop._results.get(rid)
                if res is not None:  # retired: stamped by the loop after the chunk's device read
                    rec = in_flight.pop(rid)
                    rec.done_s = rec.submit_s + res.queue_s + res.serve_s
                    rec.wait_s = res.wait_s
                    rec.tokens = list(res.tokens)
        elif nxt < len(requests):
            with tracer.range("wait"):
                time.sleep(max(0.0, requests[nxt].due_s - clock()))
        else:
            break
        if closed is not None and clock() - closed[0] > drain_limit_s:
            break
    now = clock()
    if closed is None:
        closed = (now, tokens_read(loop, skip_rids))
    tracer.close(now)
    if tracer.closed_at is not None and "close" not in trace_edges:
        trace_edges["close"] = tokens_read(loop, skip_rids)
    if on_card:
        torch.cuda.synchronize()
    admissions.close()
    for a, rec in zip(admissions.log, [r for r in records if r.rid is not None]):
        if rec.index in kept:
            kept[rec.index].events = a.events
    return Window(records=records, admissions=admissions.log, seconds=closed[0], tokens=closed[1], kept=kept,
                  trace_tokens=(trace_edges.get("open", 0), trace_edges.get("close", 0)))

