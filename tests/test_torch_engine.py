"""PyTorch port vs the JAX package: the compressed prefill and greedy decode.

The JAX ``CompressionEngine(attn_impl="einsum")`` and the port's engine run
the same weights (carried with ``params_from_numpy``) and the same prompts
— ``tests/test_engine.build_inputs`` scenarios and its cross-mode fuzz
knobs — at a tiny fp32 geometry. Compression events, keep decisions (final
lengths), per-layer cache lengths and greedy tokens must be EQUAL; logits
and cache contents agree to 1e-4 (fp32 on both sides, summed in different
orders through six layers). The port runs with ``attn_impl="flash"``, so
its kernel wrappers' plain versions carry the CPU path.
"""

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
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs, build_video_prompt
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from test_engine import build_inputs

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
    with pytest.raises(NotImplementedError):
        FrameFusionModel(family="qwen2_vl", cfg=tcfg, params=tp)


def test_video_prompt_equals_bench():
    got = build_video_prompt(np.random.default_rng(0), 64, n_frames=4, patch_num=7)
    want = bench.build_video_prompt(np.random.default_rng(0), 64, n_frames=4, patch_num=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
