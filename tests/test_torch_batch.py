"""PyTorch port vs the JAX package: the batched main path.

The lockstep-batched planned prefill (``prefill_planned_batch``), the
batched decode (``generate_batch``, one captured CUDA graph of
``decode_step_batch`` on the card, the same step body run eagerly here),
the model's and the baselines' ``generate_batch``. The JAX
``CompressionEngine(attn_impl="einsum")`` and the port's engine
(``attn_impl="flash"``: the kernel wrappers' plain versions on the CPU) run
the same weights (``params_from_numpy``) at ``tests/test_torch_engine.py``'s
tiny fp32 geometry on ``tests/test_engine.py``'s prompts. Decisions (events,
modes, fallbacks, per-layer cache lengths, the shared tail start) and greedy
tokens must be EQUAL; logits agree to 1e-4 (fp32 on both sides, summed in
other orders). The ``gpu`` tests at the end hold the batched graph against
the eager batched step, and kernels C and D at B rows against their plain
versions, on the card.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines import BaselineEngine as JaxBaselineEngine
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.core.schedule import CostInfeasibleError as JaxInfeasible
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.engine import best_tail_split_batch as jax_split_batch
from framefusion_tpu_torch.baselines import BaselineEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.core import CostInfeasibleError, bucket_length
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.ops.sampling import SamplerConfig, sample_token
from framefusion_tpu_torch.runtime.decode_graph import BatchDecodeGraph
from framefusion_tpu_torch.runtime.engine import CompressionEngine, best_tail_split_batch
from test_core import make_sequence
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOL = 1e-4
BASE = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=6, bucket=32)
# tests/test_engine.py's three-prompt set (TestBatchedPrefill): seed, coherence, frames.
THREE = [(0, 0.8, 10), (5, 0.5, 8), (9, 0.9, 12)]


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=6)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tiny_llm_config(num_layers=6), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


def engines(stacks, ff_kw=BASE):
    jcfg, tcfg, jp, tp = stacks
    return (JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum"),
            CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw), attn_impl="flash"))


def prompts(spec=THREE):
    return [build_inputs(seed=s, coherent=c, n_frames=f) for s, c, f in spec]


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def assert_same_result(res_j, res_t):
    assert res_t.mode == res_j.mode and res_t.plan_source == res_j.plan_source
    assert events(res_t) == events(res_j)
    if res_t.mode == "planned_batch":  # the pre-event's bucket is pre_plan_len, the phase events' plan_len
        assert [e.bucket for e in res_t.telemetry.events] == [e.bucket for e in res_j.telemetry.events]
        pre_t, pre_j = res_t.telemetry.events[0], res_j.telemetry.events[0]
        assert (pre_t.above_ratio, pre_t.budget) == pytest.approx((pre_j.above_ratio, pre_j.budget), abs=0)
    assert res_t.telemetry.sparsity_list == pytest.approx(res_j.telemetry.sparsity_list, abs=0)
    assert res_t.telemetry.tail_start_layer == res_j.telemetry.tail_start_layer
    assert res_t.telemetry.final_length == res_j.telemetry.final_length
    assert res_t.valid_len == res_j.valid_len and res_t.decode_pos_base == res_j.decode_pos_base
    assert [c[2] for c in res_t.layer_caches] == [c[2] for c in res_j.layer_caches]
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    for (kt, vt, n), (kj, vj, _) in zip(res_t.layer_caches, res_j.layer_caches):
        np.testing.assert_allclose(kt[:n].numpy(), np.asarray(kj[:n], np.float32), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(vt[:n].numpy(), np.asarray(vj[:n], np.float32), atol=TOL, rtol=TOL)


# -- the batched prefill ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_tail_split_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        b, n_layers = int(rng.integers(1, 5)), int(rng.integers(2, 9))
        lens = [[int(x) for x in rng.integers(1, 700, n_layers)] for _ in range(b)]
        new = int(rng.integers(1, 40))
        bucket = int(rng.choice([32, 128]))
        s_pool = bucket_length(max(max(seq) for seq in lens) + new, bucket)
        assert best_tail_split_batch(lens, s_pool, s_pool - new, bucket) == jax_split_batch(
            lens, s_pool, s_pool - new, bucket)


@pytest.mark.parametrize("case", ["analytic", "history", "explicit_tight"])
def test_prefill_planned_batch_matches_jax(stacks, case):
    """The three prompts through both lockstep batches: with the analytic
    buckets; after solo fused runs seeded PlanHistory; and at 32-token
    buckets (tests/test_engine.py's tight case), where two prompts overflow
    and fall back on their own while the third stays planned, the
    overflowing ones having ridden the lockstep loop on their cut state."""
    eng_j, eng_t = engines(stacks)
    ps = prompts()
    kw = dict(plan_len=32, pre_plan_len=32) if case == "explicit_tight" else {}
    if case == "history":
        for h, pt, pos, start, n_img in ps:
            eng_j.prefill(h, pt, pos, 6, start, n_img)
            eng_t.prefill(h, pt, pos, 6, start, n_img)
    res_j = eng_j.prefill_planned_batch(ps, patch_num=6, **kw)
    res_t = eng_t.prefill_planned_batch(ps, patch_num=6, **kw)
    for a, b in zip(res_j, res_t):
        assert_same_result(a, b)
    modes = [r.mode for r in res_t]
    if case == "explicit_tight":
        assert modes == ["planned_batch", "planned_fallback_fused", "planned_fallback_fused"]
    else:
        assert modes == ["planned_batch"] * 3 and {r.plan_source for r in res_t} == {case}
    assert eng_t.generate_batch(res_t, 4) == eng_j.generate_batch(res_j, 4)


def test_prefill_planned_batch_pool_fallback_matches_jax(stacks):
    """A phase deeper than a one-layer pool: the sequences still compressing
    after it fall back, as in JAX."""
    jcfg, tcfg, jp, tp = stacks
    ff_kw = dict(BASE, cost=0.5, similarity_lower_bound=0.8)
    eng_j = JaxEngine(jp, jcfg, JaxFF(**ff_kw), attn_impl="einsum", pool_layers=1)
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**ff_kw), pool_layers=1)
    ps = prompts([(0, 0.3, 10), (0, 0.8, 10)])
    res_j, res_t = eng_j.prefill_planned_batch(ps, patch_num=6), eng_t.prefill_planned_batch(ps, patch_num=6)
    assert [r.mode for r in res_t] == ["planned_fallback_fused", "planned_batch"]
    for a, b in zip(res_j, res_t):
        assert_same_result(a, b)


def test_prefill_planned_batch_infeasible_cost_raises_like_jax(stacks):
    ps = prompts([(3, 0.0, 10), (0, 0.8, 10)])
    eng_j, eng_t = engines(stacks, dict(BASE, cost=0.05))
    with pytest.raises(JaxInfeasible):
        eng_j.prefill_planned_batch(ps, patch_num=6)
    with pytest.raises(CostInfeasibleError):
        eng_t.prefill_planned_batch(ps, patch_num=6)


def test_prune_on_exhausted_infeasible_schedule_flags(stacks):
    # Every event slot used and the budget spent (remaining_layers == 0): the
    # lockstep batch reaches the prune before it raises, so the prune must
    # round a finite ratio and leave the raise to the executor.
    from framefusion_tpu_torch.runtime.engine import _PhaseState

    _, eng_t = engines(stacks, dict(BASE, cost=0.05))
    n, start, img = 40, 4, 30
    st = _PhaseState(n_live=n, frame_tok=img, sparsity=[0.1] * 6, fm=True)
    live = torch.ones(n, dtype=torch.bool)
    importance = torch.arange(n, dtype=torch.float32)
    live = eng_t._prune_event(st, importance, live, 3, orig_len=n, image_start=start, image_len=img)
    assert st.infeasible and st.fp
    assert int(live.sum()) == n - img  # ratio 1.0: no image token kept


# -- the batched decode -----------------------------------------------------------


def fused_results(eng_j, eng_t, spec):
    res_j, res_t = [], []
    for s, c, f in spec:
        h, pt, pos, start, n_img = build_inputs(seed=s, coherent=c, n_frames=f)
        res_j.append(eng_j.prefill(h, pt, pos, 6, start, n_img))
        res_t.append(eng_t.prefill(h, pt, pos, 6, start, n_img))
    return res_j, res_t


@pytest.mark.parametrize("case", ["three", "split", "dense", "eos"])
def test_generate_batch_matches_jax(stacks, case):
    """tests/test_engine.py's batched decodes: three ragged prompts; a batch
    whose geometry takes best_tail_split_batch (:645); a dense result in
    the batch (:704); the eos cut (:714). The port's tokens equal JAX's and
    each sequence's solo decode."""
    eng_j, eng_t = engines(stacks)
    n, eos = 5, None
    if case == "three":
        res_j, res_t = fused_results(eng_j, eng_t, THREE)
    elif case == "split":
        res_j, res_t = fused_results(eng_j, eng_t, [(3, 0.3, 10), (7, 0.4, 10)])
    elif case == "dense":
        res_j, res_t = fused_results(eng_j, eng_t, [(1, 0.7, 10)])
        h, _, pos, _, _ = build_inputs(seed=1, coherent=0.7)
        res_j.append(eng_j.dense_prefill(h, pos))
        res_t.append(eng_t.dense_prefill(h, pos))
        n = 4
    else:
        res_j, res_t = fused_results(eng_j, eng_t, [(0, 0.8, 10)])
        n = 6
        eos = eng_t.generate_batch(res_t, n)[0][2]
    graph = eng_t.batch_decode_graph(res_t, n)
    lens = [[c[2] for c in r.layer_caches] for r in res_j]
    s_pool = bucket_length(max(max(seq) for seq in lens) + n, 32)
    assert graph.tail_split == jax_split_batch(lens, s_pool, s_pool - n, 32)
    assert graph.tail_split is not None or case != "split"
    got = eng_t.generate_batch(res_t, n, eos_token_id=eos)
    assert got == eng_j.generate_batch(res_j, n, eos_token_id=eos)
    assert got == [eng_t.generate(r, n, eos_token_id=eos) for r in res_t]
    if eos is not None:
        full = eng_t.generate_batch(res_t, n)[0]
        assert got[0] == full[: full.index(eos) + 1] and len(got[0]) < n


@pytest.mark.parametrize("attn_impl,split", [("einsum", None), ("flash", None), ("flash", (2, 32, 96))])
def test_decode_step_batch_device_form_is_bitwise_its_host_form(stacks, attn_impl, split):
    """A device ``step`` and (B,) positions (the captured graph's form)
    give the host-int form's logits and pools bit for bit, step by step."""
    _, tcfg, _, tp = stacks
    gen = torch.Generator().manual_seed(0)
    b, s_pool, write_pos = 3, 128, 96
    shape = (tcfg.num_layers, b, s_pool, tcfg.num_kv_heads, tcfg.head_dim_)
    k_host, v_host = torch.randn(shape, generator=gen) * 0.1, torch.randn(shape, generator=gen) * 0.1
    k_dev, v_dev = k_host.clone(), v_host.clone()
    lens = torch.randint(5, 30 if split else 90, (tcfg.num_layers, b), generator=gen)
    pos0 = [40, 71, 88]
    for step in range(4):
        emb = torch.randn((b, tcfg.hidden_size), generator=gen) * 0.05
        want = tq.decode_step_batch(tp, emb, [p + step for p in pos0], k_host, v_host, lens.tolist(), write_pos, step,
                                    tcfg, attn_impl=attn_impl, tail_split=split)[0]
        step_t = torch.tensor(step)
        got = tq.decode_step_batch(tp, emb, torch.tensor(pos0) + step_t, k_dev, v_dev, lens, write_pos, step_t, tcfg,
                                   attn_impl=attn_impl, tail_split=split)[0]
        assert torch.equal(got, want)
        assert torch.equal(k_dev, k_host) and torch.equal(v_dev, v_host)


def test_sampled_batch_keeps_each_row_to_its_top_k(stacks):
    """Batched sampling is the one-row inverse-CDF rule per row, with the
    row's own uniform (each row's token is the one-row sampler's); a
    sampled generate_batch keeps every row's token to its step's top-k and
    is the generator's (one seed, one sequence)."""
    logits = torch.randn((4, 64), generator=torch.Generator().manual_seed(1)) * 3
    u = torch.rand(4, generator=torch.Generator().manual_seed(2))
    for cfg in (SamplerConfig(temperature=0.9, top_k=5), SamplerConfig(temperature=1.3, top_p=0.6),
                SamplerConfig()):
        rows = sample_token(logits, cfg, u=u)
        assert rows.shape == (4,)
        assert rows.tolist() == [int(sample_token(logits[i], cfg, u=u[i])) for i in range(4)]
    _, eng_t = engines(stacks)
    _, res = fused_results(engines(stacks)[0], eng_t, THREE)
    sampler = SamplerConfig(temperature=1.5, top_k=5)
    runs = [eng_t.generate_batch(res, 6, sampler=sampler, generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    graph = eng_t._start_batch_decode(res, 6, sampler, torch.Generator().manual_seed(3))
    try:
        for b, r in enumerate(res):
            assert int(graph.out[0, b]) in torch.topk(r.logits, 5).indices.tolist()
        for step in range(5):
            graph.run(1)
            for b in range(len(res)):
                assert int(graph.out[step + 1, b]) in torch.topk(graph.logits[b], 5).indices.tolist()
    finally:
        graph.busy = False


def test_generate_batch_refuses_more_rows_than_kernel_c_takes(stacks):
    # JAX's stacked matvec asserts rows <= 64; the port's kernels refuse
    # them too, and nothing routes them to the plain projections.
    _, eng_t = engines(stacks)
    _, res = fused_results(engines(stacks)[0], eng_t, THREE[:1])
    with pytest.raises(ValueError, match="B <= 64"):
        eng_t.generate_batch(res * 65, 2)


def test_batch_graphs_are_cached_by_geometry(stacks):
    """A second batch of the same geometry replays the same batched graph
    (its pools refilled) and gives its own tokens; another B is a graph of
    its own beside the solo decode's."""
    _, eng = engines(stacks)
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.8)
    res_a = [eng.prefill(h, pt, pos, 6, start, n_img), eng.prefill(h * 1.5, pt, pos, 6, start, n_img)]
    res_b = [eng.prefill(h * 0.7, pt, pos, 6, start, n_img), eng.prefill(h * 1.2, pt, pos, 6, start, n_img)]
    assert [[c[2] for c in r.layer_caches] for r in res_a] == [[c[2] for c in r.layer_caches] for r in res_b]
    toks_a = eng.generate_batch(res_a, 6)
    graph = eng.batch_decode_graph(res_a, 6)
    assert isinstance(graph, BatchDecodeGraph) and graph.k_pool.shape[1] == 2
    toks_b = eng.generate_batch(res_b, 6)
    assert eng.batch_decode_graph(res_b, 6) is graph and len(eng._graphs) == 1
    assert toks_a == [eng.generate(r, 6) for r in res_a] and toks_b == [eng.generate(r, 6) for r in res_b]
    assert toks_a != toks_b and len(eng._graphs) == 2
    eng.generate_batch(res_a[:1], 6)
    assert len(eng._graphs) == 2 and eng.batch_decode_graph(res_a, 6) is not graph  # LRU of two geometries
    with pytest.raises(ValueError, match="empty batch"):
        eng.generate_batch([], 4)


# -- the entry points -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "planned_batch"])
def test_model_generate_batch_matches_jax(stacks, mode):
    jcfg, tcfg, jp, tp = stacks
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.4, 0.75, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.4, 0.75, 0.05)
    for m in (jm, tm):
        m.ff = m.ff.replace(schedule_num_layers=6, bucket=32)
    ins_j, ins_t = [], []
    for h, pt, pos, start, n_img in prompts():
        kw = dict(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
                  image_token_length=n_img)
        ins_j.append(JaxInputs(**kw))
        ins_t.append(PrefillInputs(**kw))
    toks_j, res_j = jm.generate_batch(ins_j, max_new_tokens=4, mode=mode)
    toks_t, res_t = tm.generate_batch(ins_t, max_new_tokens=4, mode=mode)
    assert toks_t == toks_j and [r.mode for r in res_t] == [mode] * 3
    for a, b in zip(res_j, res_t):
        assert_same_result(a, b)
    dense = FrameFusionModel(family="llava_video", cfg=tcfg, params=tp)
    toks_d, res_d = dense.generate_batch(ins_t[:2], max_new_tokens=3, mode=mode)
    assert [r.mode for r in res_d] == ["dense"] * 2
    assert toks_d == JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum").generate_batch(
        ins_j[:2], max_new_tokens=3, mode=mode)[0]
    spec_j, _ = jm.generate_batch(ins_j, max_new_tokens=6, mode=mode, speculative=True, draft_len=3)
    spec_t, _ = tm.generate_batch(ins_t, max_new_tokens=6, mode=mode, speculative=True, draft_len=3)
    assert spec_t == spec_j and [row[:4] for row in spec_t] == toks_t


def _sink_prompt(scale):
    """tests/test_torch_baselines.py's 128-token prompt, scaled: the JAX
    StreamingLLM prefill reads its first logits from a pad row at lengths
    off the bucket (ROADMAP Queue 3)."""
    h, pt, img_start, n_img = make_sequence(np.random.default_rng(0), 4, 6, 20, 4, hidden=128, coherent=0.7)
    return (h * 0.05 * scale).astype(np.float32), pt, np.arange(len(pt), dtype=np.int32), img_start, n_img


def test_baseline_generate_batch_takes_the_sink_cache_decode_like_jax(stacks):
    """StreamingLLM's sink-cache variant decodes a batch one windowed decode
    a sequence (tests/test_baselines.py:227), as JAX's ``generate_batch``
    does; a sampled batch raises; the other baselines take the engine's
    batched decode."""
    jcfg, tcfg, jp, tp = stacks
    kwargs = {"init_num": 4, "length_rate": 0.5, "sink_cache_decode": True, "window_length": 24,
              "num_sink_tokens": 4}
    eng_j = JaxBaselineEngine(jp, jcfg, "streamingllm", kwargs, attn_impl="einsum")
    eng_t = BaselineEngine(tp, tcfg, "streamingllm", kwargs)
    res_j = [eng_j.prefill(*_sink_prompt(s)[:3], 6, *_sink_prompt(s)[3:]) for s in (1.0, 1.5)]
    res_t = [eng_t.prefill(*_sink_prompt(s)[:3], 6, *_sink_prompt(s)[3:]) for s in (1.0, 1.5)]
    got = eng_t.generate_batch(res_t, 6)
    assert got == eng_j.generate_batch(res_j, 6) == [eng_j.generate_greedy(r, 6) for r in res_j]
    assert got[0] != got[1]
    with pytest.raises(NotImplementedError):
        eng_t.generate_batch(res_t, 4, sampler=SamplerConfig(temperature=0.7))
    fastv = {"fastv_k": 2, "fastv_r": 0.5}
    fj = JaxBaselineEngine(jp, jcfg, "fastv", fastv, attn_impl="einsum", bucket=32)
    ft = BaselineEngine(tp, tcfg, "fastv", fastv, bucket=32)
    rj = [fj.prefill(*_sink_prompt(s)[:3], 6, *_sink_prompt(s)[3:]) for s in (1.0, 1.5)]
    rt = [ft.prefill(*_sink_prompt(s)[:3], 6, *_sink_prompt(s)[3:]) for s in (1.0, 1.5)]
    assert ft.generate_batch(rt, 5) == fj.generate_batch(rj, 5)


def test_roadmap_items_the_port_names_exist():
    """Every "ROADMAP item "<title>"" a message of the port names is an
    item heading of ROADMAP.md, so a renumbering cannot make it stale."""
    root = Path(__file__).resolve().parents[1]
    headings = {re.sub(r"[`*]", "", m).rstrip(".").strip()
                for m in re.findall(r"^\s*\d+\.\s+\*\*(.+?)\*\*", (root / "ROADMAP.md").read_text(), re.M)}
    named = {m for p in (root / "framefusion_tpu_torch").rglob("*.py")
             for m in re.findall(r'ROADMAP item "([^"]+)"', p.read_text())}
    assert named >= {"parallel/"}
    assert named <= headings, named - headings
    assert not [p.name for p in (root / "framefusion_tpu_torch").rglob("*.py")
                if re.search(r"ROADMAP Queue \d+ item \d+", p.read_text())]


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_batch_graph_equals_eager_batched_step(cuda):
    """The captured batched decode (kernels C and D for all B rows inside
    the graph) against eager host-int ``decode_step_batch`` steps on the
    card, teacher forced: each step's (B, V) logits within chip_smoke's
    LOGIT_RTOL (6e-2 of the largest), the same greedy tokens as the
    engine's generate_batch, the replays counted by the graph."""
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph

    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=torch.bfloat16)
    params = tq.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = CompressionEngine(params, cfg, FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6,
                                                           ratio_lower_bound=0.1, schedule_num_layers=6, bucket=32))
    batch = []
    for seed, coherent in ((5, 0.35), (6, 0.45), (7, 0.55)):
        h, pt, img_start, n_img = build_video_prompt(np.random.default_rng(seed), cfg.hidden_size, n_frames=12,
                                                     patch_num=8, n_pre=6, n_post=5, coherent=coherent)
        batch.append((torch.from_numpy(h).to(cuda, torch.bfloat16), pt, np.arange(len(pt)), img_start, n_img))
    res = eng.prefill_planned_batch(batch, patch_num=8)
    n = 8
    toks = eng.generate_batch(res, n)
    graph = eng.batch_decode_graph(res, n)
    assert graph.graph is not None and graph.launches_per_step == {"gemv_stacked": 3 * 6, "gemv_gateup": 6}
    replays = DecodeGraph.replays
    assert eng.generate_batch(res, n) == toks and DecodeGraph.replays - replays == n - 1
    k_pool, v_pool = torch.zeros_like(graph.k_pool), torch.zeros_like(graph.v_pool)
    for b, r in enumerate(res):
        eng.make_decode_state(r, n, pools=(k_pool, v_pool), column=b)
        eng.make_decode_state(r, n, pools=(graph.k_pool, graph.v_pool), column=b)
    lens = [[int(r.layer_caches[l][2]) for r in res] for l in range(cfg.num_layers)]
    pos = [r.decode_pos_base for r in res]
    graph.start(lens, pos, torch.stack([r.logits for r in res]))
    tok, eager = torch.stack([torch.argmax(r.logits) for r in res]), [[int(torch.argmax(r.logits))] for r in res]
    for step in range(n - 1):
        logits = tq.decode_step_batch(params, tq.embed(params, tok), [p + step for p in pos], k_pool, v_pool, lens,
                                      graph.write_pos, step, cfg, attn_impl="flash", tail_split=graph.tail_split)[0]
        graph.tok.copy_(tok)
        graph.run(1)
        err = float((graph.logits - logits).abs().max() / logits.abs().max())
        assert err <= 6e-2, (step, err)
        tok = torch.argmax(logits, dim=-1)
        for b in range(len(res)):
            eager[b].append(int(tok[b]))
    graph.busy = False
    assert eager == toks


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cuda_gemv_at_batch_rows_matches_plain_and_repeats(cuda, rows, dtype):
    """Kernels C and D with the batched decode's B rows at Qwen2-7B's
    q/k/v and gate-up widths (2 layers): within GEMV_RTOL (1e-4 of the
    largest output) of their plain versions, and bitwise the same over two
    calls and over three replays of one captured launch."""
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
    from framefusion_tpu_torch.ops.quant import quantize_weight
    from framefusion_tpu_torch.runtime.decode_graph import capture_graph

    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, 3584), generator=gen, device=cuda).to(torch.bfloat16)
    stacks, scales = [], []
    for n in (3584, 512, 512, 18944, 18944):
        w = (torch.randn((2, 3584, n), generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
        if dtype == "int8":
            wq = quantize_weight(w)
            w, s = wq["q8"], wq["scale"]
        else:
            s = None
        stacks.append(w)
        scales.append(s)
    qkv, (wg, wu), (sg, su) = stacks[:3], stacks[3:], scales[3:]
    outs = list(tmv.gemv_stacked(x, qkv, 1)) + [tmv.gemv_gateup(x, wg, wu, sg, su, 1)]
    refs = list(tmv.gemv_stacked_plain(x, qkv, 1)) + [tmv.gemv_gateup_plain(x, wg, wu, sg, su, 1)]
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape and got.shape[0] == rows
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    again = list(tmv.gemv_stacked(x, qkv, 1)) + [tmv.gemv_gateup(x, wg, wu, sg, su, 1)]
    assert all(torch.equal(a, b) for a, b in zip(again, outs))
    held = {}
    graph = capture_graph(lambda: held.update(outs=list(tmv.gemv_stacked(x, qkv, 1))
                                              + [tmv.gemv_gateup(x, wg, wu, sg, su, 1)]), cuda)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(held["outs"], outs))
