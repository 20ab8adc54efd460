"""PyTorch port vs the JAX package: the compressed prefill and decode.

The JAX ``CompressionEngine(attn_impl="einsum")`` and the port's engine run
the same weights (carried with ``params_from_numpy``) and the same prompts
— ``tests/test_engine.build_inputs`` scenarios and its cross-mode fuzz
knobs — at a tiny fp32 geometry. Compression events, keep decisions (final
lengths), per-layer cache lengths and greedy tokens must be EQUAL; logits
and cache contents agree to 1e-4 (fp32 on both sides, summed in different
orders through six layers). The port runs with ``attn_impl="flash"``, so
its kernel wrappers' plain versions carry the CPU path, and its decode
entry points run the decode graph's step body eagerly (the card replays it
as a captured CUDA graph; the ``gpu`` tests at the end hold the two
against each other there). The merge events' similarity vectors agree to
rtol 1e-4 / atol 1e-5, as tests/test_engine.py holds JAX's against its
oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.core.schedule import CostInfeasibleError as JaxInfeasible
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.core import CostInfeasibleError
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion, get_token_type
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.runtime.engine import best_tail_split
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOL = 1e-4
BASE = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=6, bucket=32)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=6)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tiny_llm_config(num_layers=6), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def assert_same(res_j, res_t, eng_j, eng_t, n_new=5):
    assert events(res_t) == events(res_j)
    assert res_t.valid_len == res_j.valid_len
    assert res_t.telemetry.tail_start_layer == res_j.telemetry.tail_start_layer
    assert [c[2] for c in res_t.layer_caches] == [c[2] for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    for (kt, _, n), (kj, _, _) in zip(res_t.layer_caches, res_j.layer_caches):
        np.testing.assert_allclose(kt[:n].numpy(), np.asarray(kj[:n], np.float32), atol=TOL, rtol=TOL)
    assert eng_t.generate(res_t, n_new) == eng_j.generate(res_j, n_new)


def run_pair(stacks, h, pt, pos, patch_num, start, n_img, mode, ff_kw=BASE, pool_layers=8, **kw):
    jcfg, tcfg, jp, tp = stacks
    eng_j = JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum", pool_layers=pool_layers)
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw), attn_impl="flash", pool_layers=pool_layers)
    if mode == "planned_explicit":
        res_j = eng_j.prefill_planned(h, pt, pos, patch_num, start, n_img, **kw)
        res_t = eng_t.prefill_planned(h, pt, pos, patch_num, start, n_img, **kw)
    else:
        res_j = eng_j.prefill(h, pt, pos, patch_num, start, n_img, mode=mode)
        res_t = eng_t.prefill(h, pt, pos, patch_num, start, n_img, mode=mode)
    return eng_j, eng_t, res_j, res_t


@pytest.mark.parametrize("mode", ["fused", "planned"])
@pytest.mark.parametrize("seed,coherent,ff_kw", [
    (0, 0.8, BASE),  # capped first merge: compression ends at layer -1
    (0, 0.3, dict(BASE, cost=0.5, similarity_lower_bound=0.8)),  # merges at -1, 0, 1, then the prune
    (1, 0.0, BASE),  # incoherent video: the prune carries the budget
    (2, 1.0, dict(BASE, cost=0.25, similarity_lower_bound=0.5)),  # budget cap, no prune
])
def test_scenarios_match_jax(stacks, mode, seed, coherent, ff_kw):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    eng_j, eng_t, res_j, res_t = run_pair(stacks, h, pt, pos, 6, start, n_img, mode, ff_kw)
    assert res_t.mode == res_j.mode == mode
    assert len(res_t.telemetry.events) >= 1
    assert_same(res_j, res_t, eng_j, eng_t)


@pytest.mark.parametrize("seed", [20, 21, 22, 3])
def test_cross_mode_fuzz_matches_jax(stacks, seed):
    """test_engine.TestCrossModeFuzz's knob and layout draws (importance
    rows 1 or 4, buckets 32/64, patch geometry) through both engines."""
    rng = np.random.default_rng(seed)
    ff_kw = dict(cost=float(rng.uniform(0.25, 0.7)), similarity_lower_bound=float(rng.uniform(0.45, 0.9)),
                 ratio_lower_bound=float(rng.uniform(0.02, 0.15)), schedule_num_layers=6,
                 bucket=int(rng.choice([32, 64])), num_importance_queries=int(rng.choice([1, 4])))
    patch_num = int(rng.integers(3, 8))
    h, pt, pos, start, n_img = build_inputs(
        seed=seed, patch_num=patch_num, n_frames=int(rng.integers(4, 12)), n_pre=int(rng.integers(1, 6)),
        n_post=int(rng.integers(1, 6)), coherent=float(rng.uniform(0.2, 1.0)))
    mode = ["fused", "planned", "measured"][seed % 3]
    eng_j, eng_t, res_j, res_t = run_pair(stacks, h, pt, pos, patch_num, start, n_img, mode, ff_kw)
    assert (res_t.mode, res_t.plan_source) == (res_j.mode, res_j.plan_source)
    assert_same(res_j, res_t, eng_j, eng_t, n_new=3)


def test_measured_then_auto_plan_from_history(stacks):
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
    ff_kw = dict(BASE, cost=0.5, similarity_lower_bound=0.8)
    jcfg, tcfg, jp, tp = stacks
    eng_j = JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum")
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw))
    for mode, source in (("auto", "measured"), ("auto", "history")):
        res_j = eng_j.prefill(h, pt, pos, 6, start, n_img, mode=mode)
        res_t = eng_t.prefill(h, pt, pos, 6, start, n_img, mode=mode)
        assert (res_t.mode, res_t.plan_source) == (res_j.mode, res_j.plan_source) == ("planned", source)
        assert events(res_t) == events(res_j)


@pytest.mark.parametrize("case", ["tight_plan", "deep_phase", "tight_pre_plan"])
def test_planned_fallbacks_match_jax(stacks, case):
    if case == "tight_plan":  # the survivors (32) overflow a 16-token plan
        h, pt, pos, start, n_img = build_inputs(seed=0)
        args = dict(mode="planned_explicit", ff_kw=dict(BASE, bucket=16), plan_len=16)
    elif case == "deep_phase":  # compression outlives a one-layer phase
        h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
        args = dict(mode="planned", ff_kw=dict(BASE, cost=0.5, similarity_lower_bound=0.8), pool_layers=1)
    else:  # the first merge leaves 47 tokens: a 32-token pre-plan overflows
        h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
        args = dict(mode="planned_explicit", ff_kw=dict(BASE, cost=0.5, similarity_lower_bound=0.8),
                    plan_len=96, pre_plan_len=32)
    eng_j, eng_t, res_j, res_t = run_pair(stacks, h, pt, pos, 6, start, n_img, **args)
    assert res_t.mode == res_j.mode == "planned_fallback_fused"
    assert_same(res_j, res_t, eng_j, eng_t, n_new=3)


def test_dense_prefill_and_decode_match_jax(stacks):
    jcfg, tcfg, jp, tp = stacks
    h, _, pos, _, _ = build_inputs(seed=4)
    eng_j = JaxEngine(jp, jcfg, JaxFF(**BASE), attn_impl="einsum")
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**BASE))
    res_j = eng_j.prefill(h, None, pos, 6, 0, 0, mode="dense")
    res_t = eng_t.prefill(h, None, pos, 6, 0, 0, mode="dense")
    assert res_t.mode == "dense"
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    assert eng_t.generate(res_t, 4) == eng_j.generate(res_j, 4)


def test_infeasible_cost_raises_like_jax(stacks):
    h, pt, pos, start, n_img = build_inputs(seed=3, coherent=0.0)
    jcfg, tcfg, jp, tp = stacks
    ff_kw = dict(BASE, cost=0.05)
    with pytest.raises(JaxInfeasible):
        JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum").prefill(h, pt, pos, 6, start, n_img)
    with pytest.raises(CostInfeasibleError):
        CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw)).prefill(h, pt, pos, 6, start, n_img)


def test_public_entry_matches_jax(stacks):
    """apply_framefusion(FrameFusionModel(...)) then generate, as a user calls it."""
    jcfg, tcfg, jp, tp = stacks
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
    kw = dict(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
              image_token_length=n_img)
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.5, 0.8, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.5, 0.8, 0.05)
    toks_j, res_j = jm.generate(JaxInputs(**kw), max_new_tokens=5)
    toks_t, res_t = tm.generate(PrefillInputs(**kw), max_new_tokens=5)
    assert toks_t == toks_j
    assert events(res_t) == events(res_j)
    # Every family of FAMILIES has its adapter now; a name outside it is refused.
    assert get_token_type("minicpmv").__name__ == "framefusion_tpu_torch.models.adapters.minicpmv"
    with pytest.raises(NotImplementedError, match="not supported"):
        get_token_type("gpt2")
    with pytest.raises(NotImplementedError, match="not supported"):
        FrameFusionModel(family="gpt2", cfg=tcfg, params=tp)


def test_video_prompt_equals_bench():
    got = build_video_prompt(np.random.default_rng(0), 64, n_frames=4, patch_num=7)
    want = bench.build_video_prompt(np.random.default_rng(0), 64, n_frames=4, patch_num=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# -- the decode entry points and the segmented prefill --------------------------------


@pytest.mark.parametrize("mode,seed,coherent,ff_kw,split", [
    ("fused", 0, 0.3, dict(BASE, cost=0.5, similarity_lower_bound=0.8), False),
    ("segmented", 1, 0.5, BASE, False),
    ("fused", 3, 0.3, BASE, True),  # test_engine's tail-split case: phase caches far longer than the tail
])
def test_generate_device_and_stream_match_jax(stacks, mode, seed, coherent, ff_kw, split):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    eng_j, eng_t, res_j, res_t = run_pair(stacks, h, pt, pos, 6, start, n_img, mode, ff_kw)
    assert events(res_t) == events(res_j)
    n = 10
    lens = [c[2] for c in res_t.layer_caches]
    graph = eng_t.decode_graph(res_t, n)
    assert (graph.tail_split is not None) == split == (best_tail_split(lens, graph.k_pool.shape[1], n, 32) is not None)
    toks_j = [int(t) for t in np.asarray(eng_j.generate_device(res_j, n))]
    dev = eng_t.generate_device(res_t, n)
    assert dev.dtype == torch.int64 and dev.shape == (n,) and dev.tolist() == toks_j
    assert eng_t.generate(res_t, n) == eng_j.generate(res_j, n) == toks_j
    assert eng_t.generate_greedy(res_t, n) == toks_j
    chunks = list(eng_t.generate_stream(res_t, n, chunk=4))
    assert chunks == list(eng_j.generate_stream(res_j, n, chunk=4))
    assert [len(c) for c in chunks] == [1, 5, 9, 10] and chunks[-1] == toks_j
    eos = toks_j[3]  # cut in the middle of the first chunk of four
    cut = list(eng_t.generate_stream(res_t, n, chunk=4, eos_token_id=eos))
    assert cut == list(eng_j.generate_stream(res_j, n, chunk=4, eos_token_id=eos))
    assert cut[-1] == toks_j[: toks_j.index(eos) + 1] and all(eos not in c for c in cut[:-1])
    assert eng_t.generate(res_t, n, eos_token_id=eos) == eng_j.generate(res_j, n, eos_token_id=eos)


def test_decode_graph_is_cached_by_geometry(stacks):
    """A second prompt of the same decode geometry reuses the graph (and its
    pools); the tokens are each prompt's own."""
    _, tcfg, _, tp = stacks
    eng = CompressionEngine(tp, tcfg, FrameFusionConfig(**BASE))
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.8)
    res_a = eng.prefill(h, pt, pos, 6, start, n_img)
    res_b = eng.prefill(h * 1.5, pt, pos, 6, start, n_img)
    assert [c[2] for c in res_a.layer_caches] == [c[2] for c in res_b.layer_caches]
    toks_a, graph = eng.generate(res_a, 6), eng.decode_graph(res_a, 6)
    toks_b = eng.generate(res_b, 7)  # the same 16 token slots
    assert eng.decode_graph(res_b, 7) is graph and len(eng._graphs) == 1
    fresh = CompressionEngine(tp, tcfg, FrameFusionConfig(**BASE))
    assert toks_a == fresh.generate(res_a, 6) and toks_b == fresh.generate(res_b, 7) and toks_a != toks_b[:6]


def test_interleaved_decodes_keep_their_own_state(stacks):
    """Two streams of one geometry advanced in turns, and a ``generate``
    between two chunks, on one engine: each decode runs on a graph of its
    own (JAX's calls each keep their own state), so each gives the tokens
    it gives alone; a finished or closed stream frees its graph."""
    _, tcfg, _, tp = stacks
    eng = CompressionEngine(tp, tcfg, FrameFusionConfig(**BASE))
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.8)
    res_a = eng.prefill(h, pt, pos, 6, start, n_img)
    res_b = eng.prefill(h * 1.5, pt, pos, 6, start, n_img)
    alone_a, alone_b = list(eng.generate_stream(res_a, 9, chunk=2)), list(eng.generate_stream(res_b, 9, chunk=2))
    assert alone_a[-1] != alone_b[-1]
    stream_a, stream_b = eng.generate_stream(res_a, 9, chunk=2), eng.generate_stream(res_b, 9, chunk=2)
    got_a, got_b, between = [next(stream_a)], [next(stream_b)], None
    for chunk_a, chunk_b in zip(stream_a, stream_b):
        got_a.append(chunk_a)
        got_b.append(chunk_b)
        if between is None:
            between = eng.generate(res_b, 9)
    assert next(stream_b, None) is None  # zip stopped at stream_a's end: stream_b ends here
    assert got_a == alone_a and got_b == alone_b and between == alone_b[-1]
    (graphs,) = eng._graphs.values()
    assert len(graphs) == 3 and not any(g.busy for g in graphs)
    stream = eng.generate_stream(res_a, 9, chunk=2)
    next(stream)
    assert sum(g.busy for g in graphs) == 1
    stream.close()
    assert not any(g.busy for g in graphs)
    assert eng.generate(res_a, 9) == alone_a[-1] and len(graphs) == 3


def test_eager_decode_loop_gives_generate_tokens(stacks):
    """kernel_bench.generate_eager (the eager loop of host-int decode steps
    the card times against the graph) decodes the engine's tokens."""
    from framefusion_tpu_torch import kernel_bench

    h, pt, pos, start, n_img = build_inputs(seed=3, coherent=0.3)
    _, eng, _, res = run_pair(stacks, h, pt, pos, 6, start, n_img, "fused")
    assert kernel_bench.generate_eager(eng, res, 6) == eng.generate(res, 6)


# The fp32/float64 boundary: at this cost the layer-0 merge is capped with a
# budget of 0.31666666 of 60 frame tokens. float64 (JAX's segmented
# executor) keeps int(19.0) - 1 = 18 tokens marked; the fp32 product the
# fused executors take rounds to 19.
BOUNDARY = dict(BASE, cost=0.6833333373069763)


@pytest.mark.parametrize("seed,coherent,ff_kw", [
    (0, 0.3, dict(BASE, cost=0.5, similarity_lower_bound=0.8)),  # merges at -1, 0, 1, then the prune
    (1, 0.0, BASE),  # incoherent video: the prune carries the budget
    (22, None, None), (26, None, None), (30, None, None),  # test_engine's fuzz draws that JAX runs segmented
    (0, 0.8, BOUNDARY),
])
def test_segmented_prefill_matches_jax(stacks, seed, coherent, ff_kw):
    patch_num = 6
    if ff_kw is None:  # test_engine.TestCrossModeFuzz's draws for this seed
        rng = np.random.default_rng(seed)
        ff_kw = dict(cost=float(rng.uniform(0.25, 0.7)), similarity_lower_bound=float(rng.uniform(0.45, 0.9)),
                     ratio_lower_bound=float(rng.uniform(0.02, 0.15)), schedule_num_layers=6,
                     bucket=int(rng.choice([32, 64])), num_importance_queries=int(rng.choice([1, 4])))
        patch_num = int(rng.integers(3, 8))
        h, pt, pos, start, n_img = build_inputs(
            seed=seed, patch_num=patch_num, n_frames=int(rng.integers(4, 12)), n_pre=int(rng.integers(1, 6)),
            n_post=int(rng.integers(1, 6)), coherent=float(rng.uniform(0.2, 1.0)))
    else:
        h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    eng_j, eng_t, res_j, res_t = run_pair(stacks, h, pt, pos, patch_num, start, n_img, "segmented", ff_kw)
    assert res_t.mode == res_j.mode == "segmented"
    got = [(e.layer, e.kind, e.tokens_removed, e.tokens_after, e.bucket) for e in res_t.telemetry.events]
    assert got == [(e.layer, e.kind, e.tokens_removed, e.tokens_after, e.bucket) for e in res_j.telemetry.events]
    assert res_t.telemetry.sparsity_list == res_j.telemetry.sparsity_list  # Python floats, exactly
    assert res_t.telemetry.final_length == res_j.telemetry.final_length
    assert_same(res_j, res_t, eng_j, eng_t, n_new=3)
    if ff_kw is BOUNDARY:  # the fused executor's fp32 count is the other side of the boundary
        fused = eng_t.prefill(h, pt, pos, patch_num, start, n_img)
        assert [(e.kind, e.tokens_removed) for e in res_t.telemetry.events] == [("merge_capped", 18)]
        assert [(e.kind, e.tokens_removed) for e in fused.telemetry.events] == [("merge_capped", 19)]


def test_segmented_decisions_are_jax_float64_arithmetic():
    """``SegmentedEventState`` against JAX's on counts either side of a
    budget and on capped products near an integer."""
    from framefusion_tpu.runtime.engine import SegmentedEventState as JaxState
    from framefusion_tpu_torch.runtime.engine import SegmentedEventState

    def outcome(fn, *args):
        try:
            return fn(*args)
        except (CostInfeasibleError, JaxInfeasible):
            return "infeasible"

    for cost, count, frame_tok in [(0.6833333373069763, 43, 60), (0.6833333373069763, 19, 60),
                                   (0.4, 20, 60), (0.4, 12, 60), (0.55, 7, 7), (0.3, 0, 13)]:
        ff_kw = dict(BASE, cost=cost)
        jst, tst = JaxState(JaxFF(**ff_kw)), SegmentedEventState(FrameFusionConfig(**ff_kw))
        for c in (count, count // 2):
            assert outcome(tst.merge_decision, c, frame_tok) == outcome(jst.merge_decision, c, frame_tok)
            assert (tst.sparsity, tst.done) == (jst.sparsity, jst.done)
        if not tst.done:
            assert outcome(tst.prune_decision, 80, 100, 90) == outcome(jst.prune_decision, 80, 100, 90)


def test_model_prefill_passes_segmented_through(stacks):
    jcfg, tcfg, jp, tp = stacks
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
    kw = dict(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
              image_token_length=n_img)
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.5, 0.8, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.5, 0.8, 0.05)
    res_j = jm.prefill(JaxInputs(**kw), mode="segmented")
    res_t = tm.prefill(PrefillInputs(**kw), mode="segmented")
    assert res_t.mode == "segmented" and events(res_t) == events(res_j)
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed,coherent,ff_kw", [
    (0, 0.3, dict(BASE, cost=0.5, similarity_lower_bound=0.8)),  # pre-event, two phase merges, the prune
    (0, 0.8, BASE),  # one capped merge before layer 0
])
def test_debug_similarities_match_jax(stacks, seed, coherent, ff_kw):
    """One vector per event, in step with ``telemetry.events`` (a zero row
    for the prune), as JAX's fused executor records them with its layer-0
    merge compacted first (the port's fused executor always does that)."""
    jcfg, tcfg, jp, tp = stacks
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    eng_j = JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum", compact_pre_event=True)
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw))
    assert eng_t.prefill(h, pt, pos, 6, start, n_img).telemetry.similarities is None
    eng_j.debug_similarities = eng_t.debug_similarities = True
    res_j = eng_j.prefill(h, pt, pos, 6, start, n_img)
    res_t = eng_t.prefill(h, pt, pos, 6, start, n_img)
    assert events(res_t) == events(res_j)
    sims_j, sims_t = res_j.telemetry.similarities, res_t.telemetry.similarities
    assert len(sims_t) == len(sims_j) == len(res_t.telemetry.events)
    for ev, got, want in zip(res_t.telemetry.events, sims_t, sims_j):
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        if ev.kind == "prune":
            assert not got.any()


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode graph is captured only there")
    return torch.device("cuda")


def _tiny_card_engine(device):
    """chip_smoke's phase 3 model: 6 layers, hidden 512, 4 / 2 heads of 128,
    weights drawn with numpy, bf16 on the card."""
    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    n_l, d, i, q, kv = 6, 512, 1024, 512, 256
    shapes = {"wq": (n_l, d, q), "wk": (n_l, d, kv), "wv": (n_l, d, kv), "wo": (n_l, q, d), "w_gate": (n_l, d, i),
              "w_up": (n_l, d, i), "w_down": (n_l, i, d), "bq": (n_l, q), "bk": (n_l, kv), "bv": (n_l, kv)}
    layers = {k: rng.standard_normal(v, dtype=np.float32) * 0.05 for k, v in shapes.items()}
    layers.update(ln1=np.ones((n_l, d), np.float32), ln2=np.ones((n_l, d), np.float32))
    tree = {"embed": rng.standard_normal((cfg.vocab_size, d), dtype=np.float32) * 0.05, "layers": layers,
            "final_norm": np.ones(d, np.float32),
            "lm_head": rng.standard_normal((d, cfg.vocab_size), dtype=np.float32) * 0.05}

    def bf16(t):
        return {k: bf16(v) for k, v in t.items()} if isinstance(t, dict) else t.to(torch.bfloat16)

    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1, schedule_num_layers=6,
                           bucket=32)
    return CompressionEngine(bf16(tq.params_from_numpy(tree, device)), cfg, ff), cfg


def _eager_ragged(eng, res, n, tail_split, forced=None):
    """Greedy eager "ragged" steps on the card (host-int form); with
    ``forced`` a callback gets each step's (step, token fed, logits)."""
    k_pool, v_pool, lens = eng.make_decode_state(res, n)
    tok, toks = torch.argmax(res.logits), [int(torch.argmax(res.logits))]
    for step in range(n - 1):
        logits, k_pool, v_pool, lens = tq.decode_step(eng.params, tq.embed(eng.params, tok),
                                                      res.decode_pos_base + step, k_pool, v_pool, lens, eng.cfg,
                                                      attn_impl="ragged", tail_split=tail_split)
        if forced is not None:
            forced(step, tok, logits)
        tok = torch.argmax(logits)
        toks.append(int(tok))
    return toks


@pytest.mark.gpu
def test_cuda_graph_decode_equals_eager_decode(cuda):
    """The captured decode ("ragged": kernels C, D, G inside the graph)
    against eager "ragged" steps on the card: each step's logits within
    chip_smoke's LOGIT_RTOL (6e-2 of the largest) under teacher forcing, the
    same greedy tokens, the replays counted by the graph and not by the
    wrappers, the graph's own arrival counters, a second prompt of the same
    geometry replaying the same graph, and two streams in turns on two
    graphs."""
    from framefusion_tpu_torch.ops.kernels import decode_attention as tda
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph

    eng, cfg = _tiny_card_engine(cuda)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5)
    res = eng.prefill(torch.from_numpy(h).to(cuda, torch.bfloat16), pt, np.arange(len(pt)), 8, img_start, n_img)
    n = 8
    graph = eng.decode_graph(res, n)
    assert graph.graph is not None and graph.launches_per_step["ragged_decode_attn"] == cfg.num_layers
    launches, replays = tda.ragged_decode_attn.launches, DecodeGraph.replays
    replayed = DecodeGraph.replayed["ragged_decode_attn"]
    toks = eng.generate(res, n)
    assert tda.ragged_decode_attn.launches == launches  # replays: no wrapper call; the graph counts them
    assert DecodeGraph.replays - replays == n - 1
    assert DecodeGraph.replayed["ragged_decode_attn"] - replayed == (n - 1) * cfg.num_layers
    assert not any(graph.counters is buf for buf in tda._COUNTERS.values()) and int(graph.counters.abs().sum()) == 0

    def teacher_forced(result):
        """Eager greedy tokens; each step's graph logits, fed the eager token, within the bound."""
        eng.make_decode_state(result, n, pools=(graph.k_pool, graph.v_pool))
        graph.start([c[2] for c in result.layer_caches], result.decode_pos_base, result.logits)

        def check(step, tok, logits):
            graph.tok.copy_(tok)
            graph.run(1)
            err = float((graph.logits - logits).abs().max() / logits.abs().max())
            assert err <= 6e-2, (step, err)

        return _eager_ragged(eng, result, n, graph.tail_split, check)

    assert teacher_forced(res) == toks
    assert eng.generate_device(res, n).tolist() == toks
    assert list(eng.generate_stream(res, n, chunk=4))[-1] == toks
    # A second prompt of the same geometry (other cache contents and
    # logits): the same graph, replayed over the new state.
    res2 = dataclasses.replace(res, logits=res.logits.roll(7),
                               layer_caches=[(k.roll(1, dims=0), v, length) for k, v, length in res.layer_caches])
    toks2 = eng.generate(res2, n)
    assert eng.decode_graph(res2, n) is graph and len(eng._graphs) == 1 and toks2 != toks
    teacher_forced(res2)
    # Two streams in turns: each on a graph of its own, each its own tokens.
    pairs = list(zip(eng.generate_stream(res, n, chunk=4), eng.generate_stream(res2, n, chunk=4)))
    assert pairs[-1] == (toks, toks2) and len(eng._graphs[next(iter(eng._graphs))]) == 2


@pytest.mark.gpu
def test_cuda_graph_sampled_decode_keeps_to_top_k(cuda):
    """A sampled decode inside the graph (inverse CDF over the top-k set,
    uniforms drawn before the loop): every token is in its step's top 5,
    and one generator seed gives one token sequence."""
    from framefusion_tpu_torch.ops.sampling import SamplerConfig

    eng, cfg = _tiny_card_engine(cuda)
    h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(5), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5)
    res = eng.prefill(torch.from_numpy(h).to(cuda, torch.bfloat16), pt, np.arange(len(pt)), 8, img_start, n_img)
    sampler = SamplerConfig(temperature=1.5, top_k=5)
    runs = [eng.generate(res, 8, sampler=sampler, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    graph = eng.decode_graph(res, 8, sampler)
    assert graph.graph is not None
    eng.make_decode_state(res, 8, pools=(graph.k_pool, graph.v_pool))
    graph.start([c[2] for c in res.layer_caches], res.decode_pos_base, res.logits,
                torch.rand(8, generator=torch.Generator().manual_seed(2)).to(cuda))
    assert int(graph.out[0]) in torch.topk(res.logits, 5).indices.tolist()
    for step in range(7):
        graph.run(1)
        assert int(graph.out[step + 1]) in torch.topk(graph.logits, 5).indices.tolist()


def test_prune_at_a_nan_ratio_keeps_no_image_token_like_jax():
    """Four events that use every layer of a 4-layer schedule and spend the
    budget exactly (densities 0.5 + 0.25 + 0.125 + 0.125 = 4 x 0.25) leave
    the schedule's ratio 0 / 0 = NaN in both packages. JAX's phase program
    converts the keep count round(NaN) to 0 (XLA's float to int conversion)
    and prunes every image token of the window; the port's fused and planned
    executors keep the same tokens (the port's prune used to raise on it)."""
    from framefusion_tpu.core.schedule import compute_pruning_ratio_device
    from framefusion_tpu.runtime.engine import _prune_event_step
    from framefusion_tpu_torch.core.schedule import pruning_ratio_flagged
    from framefusion_tpu_torch.runtime.engine import _PhaseState

    sparsity, cost = [0.5, 0.5, 0.5, 0.0], 0.25
    ratio, infeasible = pruning_ratio_flagged(sparsity, cost, 4)
    j_ratio, j_infeasible = compute_pruning_ratio_device(jnp.asarray(sparsity, jnp.float32), jnp.int32(4),
                                                         jnp.float32(cost), 4)
    assert np.isnan(ratio) and np.isnan(float(j_ratio)) and not infeasible and not bool(j_infeasible)

    s, image_start, image_len = 24, 2, 16
    rng = np.random.default_rng(0)
    importance = rng.random(s).astype(np.float32)
    live = np.ones(s, bool)
    live[[5, 9]] = False  # two tokens merged away before the prune
    n_live = int(live.sum())
    j_st = dict(sparsity=jnp.asarray(sparsity, jnp.float32), n_events=jnp.int32(4), n_live=jnp.int32(n_live),
                live=jnp.asarray(live), infeasible=jnp.bool_(False), fp=jnp.bool_(False),
                ev_layer=jnp.zeros(8, jnp.int32), ev_kind=jnp.zeros(8, jnp.int32), ev_removed=jnp.zeros(8, jnp.int32),
                ev_ratio=jnp.zeros(8, jnp.float32), ev_budget=jnp.zeros(8, jnp.float32), ev_n=jnp.int32(4))
    j_out = _prune_event_step(j_st, None, jnp.asarray(importance), 3, jnp.int32(s), jnp.int32(image_start),
                              jnp.int32(image_len), jnp.float32(cost), schedule_num_layers=4)

    cfg = tiny_llm_config(num_layers=4)
    engine = CompressionEngine(tq.init_params(cfg, torch.Generator().manual_seed(0)), cfg,
                               FrameFusionConfig(cost=cost, schedule_num_layers=4), attn_impl="einsum")
    st = _PhaseState(n_live=n_live, frame_tok=image_len - 2, sparsity=list(sparsity), fm=True)
    keep = engine._prune_event(st, torch.from_numpy(importance), torch.from_numpy(live), 3, orig_len=s,
                               image_start=image_start, image_len=image_len)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_out["live"]))
    assert st.n_live == int(j_out["n_live"]) == n_live - (image_len - 2) and not st.infeasible
