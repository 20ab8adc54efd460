"""PyTorch port vs the JAX package: the continuous-batching serving loop.

The port's ``ServingLoop`` (one captured CUDA graph of the chunk's macro
step per tail split on the card, the same step run eagerly here) and the
JAX package's, over the same weights (``params_from_numpy``) at
``tests/test_serving.py``'s tiny fp32 geometry (4 layers, bucket 32) and
prompts, fed the same schedule: per request the tokens, ``admitted_step``
and ``prefill_mode``, and the loop's ``compactions`` and chunk count, must
EQUAL JAX's, and the tokens the port's own solo greedy decode (cut after
eos). The JAX ``CompressionEngine(attn_impl="einsum")`` against the port's
``attn_impl="einsum"`` (fp32 on both sides); the port's ``"flash"`` (the
kernel wrappers' plain versions on the CPU) against its own solo decodes.
Where JAX asserts, the port raises ``ValueError``; it refuses the
sink-cache StreamingLLM engine, which JAX serves through the full-cache
verify (ROADMAP Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines.qwen2_baselines import BaselineEngine as JaxBaselineEngine
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.serving import ServeRequest as JaxRequest
from framefusion_tpu.runtime.serving import ServingLoop as JaxLoop
from framefusion_tpu_torch.baselines import BaselineEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.runtime.serving import ServeRequest, ServingLoop
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tiny_llm_config(num_layers=4), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def engines(stacks):
    jcfg, tcfg, jp, tp = stacks
    return JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum"), CompressionEngine(tp, tcfg, FrameFusionConfig(**FF))


def _inputs(cls, seed, coherent=0.35):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    return cls(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
               image_token_length=n_img)


class Solo:
    """The port's solo greedy decodes, by (seed, tokens), cut after eos."""

    def __init__(self, engine):
        self.engine, self.cache = engine, {}

    def __call__(self, seed, n, eos=None):
        if (seed, n) not in self.cache:
            inp = _inputs(PrefillInputs, seed)
            res = self.engine.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, inp.patch_num,
                                      inp.image_token_start, inp.image_token_length)
            self.cache[(seed, n)] = self.engine.generate_greedy(res, n)
        toks = self.cache[(seed, n)]
        return toks[: toks.index(eos) + 1] if eos is not None and eos in toks else toks


@pytest.fixture(scope="module")
def solo(engines):
    return Solo(engines[1])


def _tail_pool(engine):
    """(P, tail_prefix_cap) from a sample admission's per-layer lengths, as
    tests/test_serving.py picks it."""
    inp = _inputs(PrefillInputs, 0)
    res = engine.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, inp.patch_num, inp.image_token_start,
                         inp.image_token_length)
    lens = [c[2] for c in res.layer_caches]
    p = next(l for l in range(1, len(lens)) if lens[l] < lens[0])
    return p, max(lens[p:]) + 8


def _fuzz(trial):
    """tests/test_serving.py's randomized schedules (rng 7), the ``trial``-th:
    (loop kwargs, requests as (seed, budget, eos position or None))."""
    rng = np.random.default_rng(7)
    for t in range(trial + 1):
        n_req, slots, chunk = int(rng.integers(3, 6)), int(rng.integers(1, 4)), int(rng.integers(2, 6))
        draft = int(rng.choice([0, 3]))
        reqs = []
        for _ in range(n_req):
            seed, budget = int(rng.integers(0, 50)), int(rng.integers(1, 21))
            at = None
            if budget > 4 and rng.random() < 0.4:
                lo = 0 if rng.random() < 0.25 else 2
                at = int(rng.integers(lo, budget - 1))
            reqs.append((seed, budget, at))
    return dict(max_slots=slots, max_new_cap=20, chunk_steps=chunk, draft_len=draft, prefix_cap=256), reqs


def _case(name, engine, solo):
    """(loop kwargs, requests as (seed, budget, request kwargs))."""
    base = dict(prefix_cap=256)
    if name == "fifo_1_slot":
        return dict(base, max_slots=1, max_new_cap=16, chunk_steps=4), [(0, 10, {}), (1, 6, {}), (2, 12, {})]
    if name == "fifo_2_slots":
        return dict(base, max_slots=2, max_new_cap=24, chunk_steps=4), [
            (0, 16, {}), (1, 9, {}), (2, 24, {}), (3, 5, {}), (4, 13, {})]
    if name == "compaction":
        return dict(base, max_slots=2, max_new_cap=48, chunk_steps=2), [(0, 48, {}), (1, 48, {})]
    if name == "eos_mid_chunk":
        return dict(base, max_slots=2, max_new_cap=16, chunk_steps=4), [(0, 16, {"eos_token_id": solo(0, 16)[6]})]
    if name == "eos_at_admission":
        return dict(base, max_slots=1, max_new_cap=64, chunk_steps=2), [
            (0, 64, {"eos_token_id": solo(0, 1)[0]}), (1, 6, {})]
    if name == "single_token":
        return dict(base, max_slots=2, max_new_cap=16, chunk_steps=4), [(0, 1, {}), (1, 8, {})]
    if name == "speculative":
        return dict(base, max_slots=2, max_new_cap=24, chunk_steps=4, draft_len=4), [
            (0, 24, {"prompt_ids": np.asarray(solo(0, 24))}), (1, 24, {"prompt_ids": np.asarray(solo(1, 24))}),
            (2, 20, {})]
    if name == "tail_pool_compaction":
        return dict(base, max_slots=2, max_new_cap=48, chunk_steps=2, tail_pool=_tail_pool(engine)), [
            (0, 48, {}), (1, 40, {}), (2, 48, {}), (3, 25, {}), (4, 33, {})]
    if name == "tail_pool_speculative":
        return dict(base, max_slots=2, max_new_cap=24, chunk_steps=4, draft_len=4, tail_pool=_tail_pool(engine)), [
            (s, 24, {"prompt_ids": np.asarray(solo(s, 24))}) for s in (0, 1, 2)]
    if name == "auto_prefill":
        return dict(base, max_slots=1, max_new_cap=8, chunk_steps=4, prefill_mode="auto"), [
            (0, 8, {}), (1, 8, {}), (2, 8, {})]
    kw, reqs = _fuzz(int(name[-1]))
    return kw, [(s, n, {} if at is None else {"eos_token_id": solo(s, n)[at]}) for s, n, at in reqs]


def _serve(loop, req_cls, in_cls, reqs):
    ids = [loop.submit(req_cls(_inputs(in_cls, s), max_new_tokens=n, **kw)) for s, n, kw in reqs]
    res = loop.run()
    return [(res[i].tokens, res[i].admitted_step, res[i].prefill_mode) for i in ids], res


CASES = ["fifo_1_slot", "fifo_2_slots", "compaction", "eos_mid_chunk", "eos_at_admission", "single_token",
         "speculative", "tail_pool_compaction", "tail_pool_speculative", "auto_prefill", "fuzz_0", "fuzz_1", "fuzz_2"]


@pytest.mark.parametrize("case", CASES)
def test_serving_loop_matches_jax(stacks, case):
    """The port's loop on the plain path ("einsum": fp32 like JAX's) gives
    JAX's tokens, admission chunks, prefill modes, compactions and chunk
    count; on the kernels' path ("flash": the plain versions of C, D and G,
    which round to bf16, so a near-tie of this random model may break
    otherwise than fp32) every request's tokens equal its solo greedy
    decode on that engine, on the same schedule."""
    jcfg, tcfg, jp, tp = stacks
    # Fresh engines: "auto" rides each engine's PlanHistory from empty.
    eng_j = JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum")
    eng_t = {impl: CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl=impl) for impl in ("einsum", "flash")}
    solo = {impl: Solo(CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl=impl))
            for impl in ("einsum", "flash")}
    kw, reqs = _case(case, eng_t["einsum"], solo["einsum"])
    loop_j = JaxLoop(eng_j, **kw)
    want, _ = _serve(loop_j, JaxRequest, JaxInputs, reqs)
    for impl in ("einsum", "flash"):
        loop_t = ServingLoop(eng_t[impl], **kw)
        got, res = _serve(loop_t, ServeRequest, PrefillInputs, reqs)
        for (toks, _, _), (seed, n, rkw) in zip(got, reqs):
            assert toks == solo[impl](seed, n, rkw.get("eos_token_id")), (impl, seed)
        if impl == "einsum":
            assert got == want
            assert (loop_t.compactions, loop_t._chunk_idx) == (loop_j.compactions, loop_j._chunk_idx)
        assert all(r.queue_s >= 0 and r.serve_s >= 0 for r in res.values())
        if case in ("compaction", "tail_pool_compaction"):
            assert loop_t.compactions >= 1
        if case.startswith("tail_pool"):
            assert loop_t.phys is not None and loop_t.k_tail.shape[2] < loop_t.k_pool.shape[2]
        if case == "eos_at_admission":
            assert got[0][0] == solo[impl](0, 1) and got[1][1] <= 2  # the slot freed at once
        if case == "auto_prefill":
            assert [g[2] for g in got] == ["planned"] * 3
        if case in ("fifo_1_slot", "fifo_2_slots"):
            assert max(g[1] for g in got) > 0  # later requests joined mid-stream


@pytest.mark.parametrize("case", ["budget", "prefix_capacity", "tail_capacity", "tail_layer"])
def test_refusals_match_jax(engines, case):
    """Where JAX asserts (AssertionError) the port raises ValueError, with
    the same message."""
    eng_j, eng_t = engines
    kw, match = dict(max_slots=1, max_new_cap=8, chunk_steps=4), None
    if case == "prefix_capacity":
        kw, match = dict(max_slots=1, max_new_cap=32, chunk_steps=4, prefix_cap=32), "prefix capacity"
    if case == "tail_capacity":
        kw, match = dict(max_slots=1, max_new_cap=32, chunk_steps=4, prefix_cap=256, tail_pool=(1, 8)), \
            "tail pool capacity"
    if case == "tail_layer":
        kw = dict(max_slots=1, max_new_cap=8, chunk_steps=4, tail_pool=(4, 8))
    for eng, loop_cls, req_cls, in_cls, err in ((eng_j, JaxLoop, JaxRequest, JaxInputs, AssertionError),
                                                 (eng_t, ServingLoop, ServeRequest, PrefillInputs, ValueError)):
        with pytest.raises(err, match=match):
            loop = loop_cls(eng, **kw)
            loop.submit(req_cls(_inputs(in_cls, 0), max_new_tokens=9 if case == "budget" else 8))
            loop.run()


def test_degenerate_split_serves_uniform(engines, solo):
    """tail_prefix_cap >= prefix_cap saves nothing: the uniform layout, as in JAX."""
    eng_j, eng_t = engines
    kw = dict(max_slots=1, max_new_cap=8, chunk_steps=4, prefix_cap=128, tail_pool=(2, 256))
    loop_j, loop_t = JaxLoop(eng_j, **kw), ServingLoop(eng_t, **kw)
    assert loop_t.phys is None and loop_t.k_tail is None and loop_j.phys is None
    got, _ = _serve(loop_t, ServeRequest, PrefillInputs, [(0, 8, {})])
    assert got == _serve(loop_j, JaxRequest, JaxInputs, [(0, 8, {})])[0] and got[0][0] == solo(0, 8)


def test_model_serving_loop_matches_jax(stacks):
    """``FrameFusionModel.serving_loop()`` binds the loop to the model's engine."""
    jcfg, tcfg, jp, tp = stacks
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.4, 0.75, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.4, 0.75, 0.05)
    for m in (jm, tm):
        m.ff = m.ff.replace(schedule_num_layers=4, bucket=32)
    kw = dict(max_slots=2, max_new_cap=10, chunk_steps=3, prefix_cap=128, draft_len=2)
    got, _ = _serve(tm.serving_loop(**kw), ServeRequest, PrefillInputs, [(0, 10, {}), (1, 7, {})])
    assert got == _serve(jm.serving_loop(**kw), JaxRequest, JaxInputs, [(0, 10, {}), (1, 7, {})])[0]
    assert got[0][0] == tm.engine().generate_greedy(tm.prefill(_inputs(PrefillInputs, 0)), 10)


SINK = {"init_num": 4, "length_rate": 0.5, "sink_cache_decode": True, "window_length": 24, "num_sink_tokens": 4}


def test_sink_cache_engine_jax_serves_full_cache_port_refuses(stacks):
    """ROADMAP Queue 3: JAX's ServingLoop serves StreamingLLM's sink-cache
    engine through the full-cache verify, with no guard: its tokens are
    ``CompressionEngine.generate``'s (the full cache), not the engine's own
    windowed ``generate_greedy``. The port's loop refuses that engine, as
    both packages' ``generate_spec`` do."""
    jcfg, tcfg, jp, tp = stacks
    eng_j = JaxBaselineEngine(jp, jcfg, "streamingllm", SINK, attn_impl="einsum")
    inp = _inputs(JaxInputs, 3)
    loop = JaxLoop(eng_j, max_slots=1, max_new_cap=16, chunk_steps=4, prefix_cap=256)
    rid = loop.submit(JaxRequest(inp, max_new_tokens=16))
    served = loop.run()[rid].tokens
    res = eng_j.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, inp.patch_num, inp.image_token_start,
                        inp.image_token_length)
    full = JaxEngine.generate(eng_j, res, 16)
    windowed = eng_j.generate_greedy(res, 16)
    assert served == full and served != windowed
    with pytest.raises(NotImplementedError, match="sink_cache_decode"):
        ServingLoop(BaselineEngine(tp, tcfg, "streamingllm", SINK), max_slots=1, max_new_cap=16)
    plain = dict(SINK, sink_cache_decode=False)
    assert ServingLoop(BaselineEngine(tp, tcfg, "streamingllm", plain), max_slots=1, max_new_cap=16).b == 1


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("draft_len", [0, 4])
def test_cuda_serving_chunk_graph_equals_eager_step(cuda, draft_len):
    """The captured chunk step (kernels C and D at B * K rows) against the
    same step run eagerly on the capture stream from the same state: every
    buffer bitwise equal; then every request ends."""
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.runtime.decode_graph import capture_stream

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=torch.bfloat16)
    params = tq.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = CompressionEngine(params, cfg, FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6,
                                                           ratio_lower_bound=0.1, schedule_num_layers=6, bucket=32))
    loop = ServingLoop(eng, max_slots=2, max_new_cap=16, chunk_steps=4, draft_len=draft_len, prefix_cap=512)
    for seed in range(3):
        h, pt, start, n_img = build_video_prompt(np.random.default_rng(seed), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5, coherent=0.4)
        loop.submit(ServeRequest(PrefillInputs(torch.from_numpy(h).to(cuda, torch.bfloat16), pt, np.arange(len(pt)),
                                               8, start, n_img), max_new_tokens=12 + seed))
    loop.step()
    (split, graph), = loop._graphs.items()
    assert graph.graph is not None and loop.captures == 1
    names = [k for k, v in vars(loop).items() if isinstance(v, torch.Tensor)]
    start = {k: getattr(loop, k).clone() for k in names}
    graph._replay(2)
    torch.cuda.synchronize()
    replayed = {k: getattr(loop, k).clone() for k in names}
    for k in names:
        getattr(loop, k).copy_(start[k])
    with torch.cuda.stream(capture_stream(cuda)):
        for _ in range(2):
            loop._macro_step(split)
    torch.cuda.synchronize()
    for k in names:
        assert torch.equal(getattr(loop, k), replayed[k]), k
        getattr(loop, k).copy_(start[k])  # back to the state the host knows
    results = loop.run()
    assert sorted(len(r.tokens) for r in results.values()) == [12, 13, 14]
    assert dataclasses.asdict(results[0])["request_id"] == 0
