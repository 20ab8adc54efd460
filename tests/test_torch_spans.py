"""The port's spans and serving counters, read back from a Chrome trace.

``runtime.profiling.span`` marks the served path's stages as
``framefusion.<name>[#n]`` ranges in a ``torch.profiler`` window: the
serving loop (submit, step, admission, splice, chunk and its parts), the
compressed prefill's stages, ingest (preprocessing, tower, projector,
prompt) and the checkpoint load. Here a tiny engine and ``ServingLoop`` run
under a CPU profiler, the trace is exported and read back, and the tree is
checked: each span under its parent, one request's spans sharing its id,
``serve.chunk#n`` equal to the slots active at that chunk, a planned prefill
over its bucket showing its fused re-run. With no profiler, ``span`` is one
shared no-op and opens no ``record_function``. Each ``ServeResult`` carries
its queue wait, admission seconds and the prefill's telemetry.
"""

import json

import numpy as np
import pytest
import torch

from framefusion_tpu_torch import preprocess, weights
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.models.vision import internvl_vit, llava_frontend, siglip
from framefusion_tpu_torch.pipeline import TextPipeline
from framefusion_tpu_torch.runtime import profiling
from framefusion_tpu_torch.runtime.engine import CompressionEngine, PlanHistory
from framefusion_tpu_torch.runtime.serving import ServeRequest, ServingLoop
from checkpoint_fixtures import write_fixture
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)
PATCH_NUM = 6

# Each span's parent in the served path (None: no framefusion span around it).
PARENTS = {
    "serve.submit": {None},
    "serve.step": {None},
    "serve.admit": {"serve.step"},
    "engine.prefill": {"serve.admit"},
    "engine.plan": {"engine.prefill"},
    "engine.pre_event": {"engine.prefill", "engine.fallback"},
    "engine.phase": {"engine.prefill", "engine.fallback"},
    "engine.tail": {"engine.prefill", "engine.fallback"},
    "engine.fallback": {"engine.prefill"},
    "engine.read": {"engine.plan", "engine.pre_event", "engine.phase"},
    "serve.splice": {"serve.admit"},
    "serve.chunk": {"serve.step"},
    "serve.compact": {"serve.chunk"},
    "serve.capture": {"serve.chunk"},
    "serve.upload": {"serve.chunk"},
    "serve.replay": {"serve.chunk"},
    "serve.read": {"serve.chunk"},
    "serve.retire": {"serve.chunk", "serve.admit"},  # a single-token request retires at its admission
}


class StubTokenizer:
    eos_token_id = 7

    def encode(self, text):
        return [ord(c) % 101 for c in text][:40]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


class Span:
    def __init__(self, event):
        name = event["name"][len(profiling.SPAN_PREFIX):]
        self.name, _, n = name.partition("#")
        self.n = int(n) if n else None
        self.start, self.end = float(event["ts"]), float(event["ts"]) + float(event["dur"])
        self.parent = None

    def __repr__(self):
        return f"{self.name}#{self.n}"


def spans_of(prof, tmp_path) -> list:
    """The profile's framefusion spans in start order, each with its
    innermost enclosing span as ``parent``."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((Span(e) for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(profiling.SPAN_PREFIX)), key=lambda s: (s.start, -s.end))
    stack = []
    for s in spans:
        while stack and s.start >= stack[-1].end:
            stack.pop()
        if stack:
            assert s.end <= stack[-1].end, f"{s} overlaps {stack[-1]} without nesting"
            s.parent = stack[-1]
        stack.append(s)
    return spans


def profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_llm_config(num_layers=4)
    return CompressionEngine(tq.init_params(cfg, torch.Generator().manual_seed(0)), cfg, FrameFusionConfig(**FF))


def _inputs(seed):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=0.35)
    return PrefillInputs(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=PATCH_NUM,
                         image_token_start=start, image_token_length=n_img)


# (seed, max_new_tokens): a single-token request, and enough chunks in two
# slots that the pools compact.
REQUESTS = [(0, 12), (1, 1), (2, 12), (3, 9), (4, 12), (5, 12)]


def _loop(engine, mode="planned"):
    return ServingLoop(engine, max_slots=2, max_new_cap=12, chunk_steps=3, prefill_mode=mode, prefix_cap=96)


@pytest.fixture(scope="module")
def served(engine, tmp_path_factory):
    """The loop over REQUESTS under a CPU profiler: (loop, results, the
    prefill results in admission order, spans)."""
    loop = _loop(engine)
    made, orig = [], engine.prefill

    def prefill(*args, **kwargs):
        made.append(orig(*args, **kwargs))
        return made[-1]

    engine.prefill = prefill
    try:
        with profile() as prof:
            for seed, n in REQUESTS:
                loop.submit(ServeRequest(_inputs(seed), max_new_tokens=n))
            results = loop.run()
    finally:
        del engine.prefill
    return loop, results, made, spans_of(prof, tmp_path_factory.mktemp("served"))


def test_span_tree_nests_as_specified(served):
    loop, _, _, spans = served
    seen = {s.name for s in spans}
    assert seen == set(PARENTS) - {"engine.fallback"}, seen
    for s in spans:
        assert (None if s.parent is None else s.parent.name) in PARENTS[s.name], (s, s.parent)
    assert loop.compactions > 0 and sum(s.name == "serve.compact" for s in spans) == loop.compactions
    assert sum(s.name == "serve.chunk" for s in spans) == loop._chunk_idx
    # every chunk uploads, replays and reads once
    for chunk in (s for s in spans if s.name == "serve.chunk"):
        kids = [c.name for c in spans if c.parent is chunk]
        assert [k for k in kids if k in ("serve.upload", "serve.replay")] == ["serve.upload", "serve.replay"]
        assert kids.count("serve.read") >= 1
    # no span opens inside the replayed macro step
    for s in spans:
        assert s.parent is None or s.parent.name != "serve.replay", s


def test_request_spans_share_its_id(served):
    _, results, _, spans = served
    by_name = {}
    for s in spans:
        if s.n is not None and s.name != "serve.chunk":
            by_name.setdefault(s.name, []).append(s.n)
    rids = sorted(results)
    assert rids == list(range(len(REQUESTS)))
    for name in ("serve.submit", "serve.admit", "serve.retire"):
        assert sorted(by_name[name]) == rids, name
    for rid in rids:
        submit, admit, retire = (next(s for s in spans if s.name == n and s.n == rid)
                                 for n in ("serve.submit", "serve.admit", "serve.retire"))
        assert submit.end <= admit.start < retire.start
        if REQUESTS[rid][1] == 1:
            assert retire.parent is admit
        else:
            assert retire.parent.name == "serve.chunk"


def test_chunk_span_counts_the_active_slots(served):
    """serve.chunk#n against the trace's own account: requests admitted
    before the chunk less those retired before it."""
    _, _, _, spans = served
    chunks = [s for s in spans if s.name == "serve.chunk"]
    assert chunks and all(1 <= s.n <= 2 for s in chunks)
    for chunk in chunks:
        admitted = sum(1 for s in spans if s.name == "serve.admit" and s.end <= chunk.start)
        retired = sum(1 for s in spans if s.name == "serve.retire" and s.start < chunk.start)
        assert chunk.n == admitted - retired, chunk
    assert max(s.n for s in chunks) == 2


def test_serve_result_carries_the_prefill_telemetry(served):
    _, results, made, _ = served
    assert len(made) == len(REQUESTS)
    for rid, res in sorted(results.items()):
        tel = made[rid].telemetry
        assert res.prefill_mode == made[rid].mode
        assert (res.prompt_len, res.kept_len) == (tel.original_length, tel.final_length)
        assert res.prompt_len == _inputs(REQUESTS[rid][0]).input_embeds.shape[0] > res.kept_len
        assert res.vision_token_reduction == tel.vision_token_reduction > 0
        assert res.events == [(e.layer, e.kind, e.tokens_removed) for e in tel.events] and res.events
        # queue_s keeps its meaning, submit to the end of the admission
        assert 0 <= res.wait_s <= res.queue_s and res.admit_s > 0 and res.serve_s >= 0
        assert res.wait_s + res.admit_s == pytest.approx(res.queue_s, abs=1e-9)
        assert len(res.tokens) == REQUESTS[rid][1]
    # admitted FIFO into two slots: a later request waits at least as long as
    # the one submitted just before it, less the admission between them
    assert results[0].wait_s <= results[2].wait_s


def test_dense_admission_keeps_every_token(engine):
    loop = _loop(engine, mode="dense")
    rid = loop.submit(ServeRequest(_inputs(0), max_new_tokens=2))
    res = loop.run()[rid]
    n = _inputs(0).input_embeds.shape[0]
    assert (res.prefill_mode, res.prompt_len, res.kept_len, res.vision_token_reduction, res.events) == \
        ("dense", n, n, 0.0, [])


def test_planned_prefill_over_its_bucket_shows_its_fallback(tmp_path):
    """A plan history whose buckets are too tight for the prompt: the
    planned admission re-runs fused inside ``engine.fallback``."""
    cfg = tiny_llm_config(num_layers=4)
    eng = CompressionEngine(tq.init_params(cfg, torch.Generator().manual_seed(0)), cfg, FrameFusionConfig(**FF))
    inp = _inputs(0)
    frames = int(np.sum(np.asarray(inp.patch_type) >= 0)) // PATCH_NUM
    eng.plan_history.record(PlanHistory.key(PATCH_NUM, frames, eng.ff), 1, 1)
    loop = _loop(eng)
    with profile() as prof:
        rid = loop.submit(ServeRequest(inp, max_new_tokens=2))
        res = loop.run()[rid]
    assert res.prefill_mode == "planned_fallback_fused"
    spans = spans_of(prof, tmp_path)
    (fallback,) = [s for s in spans if s.name == "engine.fallback"]
    assert fallback.parent.name == "engine.prefill" and fallback.parent.parent.name == "serve.admit"
    assert {s.name for s in spans if s.parent is fallback} >= {"engine.pre_event", "engine.phase", "engine.tail"}
    for s in spans:
        assert (None if s.parent is None else s.parent.name) in PARENTS[s.name], (s, s.parent)


def test_without_a_profiler_a_span_is_one_shared_no_op(engine, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("serve.step") is profiling.span("serve.admit", 3) is profiling._NO_SPAN
    opened = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        opened.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    loop = _loop(engine)
    for seed, n in REQUESTS[:3]:
        loop.submit(ServeRequest(_inputs(seed), max_new_tokens=n))
    loop.run()
    assert opened == []
    with profile():
        with profiling.span("serve.admit", 3):
            pass
    assert opened == ["framefusion.serve.admit#3"]


def _llava_pipe(g):
    cfg, vcfg = tiny_llm_config(num_layers=4), siglip.tiny_vit_config()
    model = apply_framefusion(FrameFusionModel(family="llava_video", cfg=cfg, params=tq.init_params(cfg, g)),
                              0.5, 0.8, 0.05)
    return TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=siglip.init_params(vcfg, g),
                        vit_cfg=vcfg, projector=llava_frontend.init_projector(g, vcfg.hidden_size, cfg.hidden_size))


def _internvl_pipe(g):
    cfg = tiny_llm_config(num_layers=4, num_heads=8, num_kv_heads=2, qkv_bias=False)
    vcfg = internvl_vit.tiny_internvit_config(attention_bias=True, text_hidden_size=cfg.hidden_size)
    model = apply_framefusion(FrameFusionModel(family="internvl", cfg=cfg, params=tq.init_params(cfg, g)),
                              0.5, 0.97, 0.05)
    return TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=internvl_vit.init_params(vcfg, g),
                        vit_cfg=vcfg, projector=internvl_vit.init_projector(vcfg, g))


@pytest.mark.parametrize("make", [_llava_pipe, _internvl_pipe], ids=["llava_video", "internvl"])
def test_ingest_spans(make, tmp_path):
    pipe = make(torch.Generator().manual_seed(0))
    frames = np.random.default_rng(0).integers(0, 256, (4, 30, 40, 3)).astype(np.uint8)
    family = pipe.model.family
    with profile() as prof:
        pixels = preprocess.preprocess_frames(frames, family, target=(pipe.vit_cfg.image_size,) * 2)
        inputs = pipe.build_inputs("What happens?", frames=pixels)
    assert inputs.input_embeds.shape[0] > 0
    spans = spans_of(prof, tmp_path)
    assert [(s.name, s.parent) for s in spans if s.parent is None] == [("preprocess.frames", None),
                                                                      ("pipeline.build_inputs", None)]
    build = spans[1]
    kids = [s.name for s in spans if s.parent is build]
    assert kids == ["vision.tower", "vision.project", "pipeline.prompt"], kids


def test_checkpoint_load_spans(tmp_path):
    path = write_fixture(tmp_path, "llava_video")
    with profile() as prof:
        weights.load_checkpoint(path, device="cpu")
    assert [s.name for s in spans_of(prof, tmp_path)] == ["weights.load_state", "weights.import_decoder",
                                                          "weights.load_vision"]
