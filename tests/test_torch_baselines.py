"""PyTorch port vs the JAX package: the baseline methods and kernel F's plain version.

The JAX ``BaselineEngine(attn_impl="einsum")`` and the port's engine run the
same weights (carried with ``params_from_numpy``) on ``tests/test_baselines``
prompts at a tiny fp32 geometry. Compression events, valid lengths,
per-layer cache lengths and greedy tokens must be EQUAL; logits and cache
contents agree to 1e-4 (fp32 on both sides, summed in other orders through
six layers). The port runs with ``attn_impl="flash"``, so the CPU path goes
through its kernel wrappers' plain versions.

StreamingLLM is compared at a prompt of 128 tokens, a multiple of the
engine's bucket: below it, the JAX program reads its logits from a pad row
(ROADMAP Queue 3), and the port reads the last live row instead.

Sink attention (fp32): kernel F's plain version (also the StreamingLLM
prefill's ``"einsum"`` route) against JAX's chunked attention and its Pallas
kernel in interpret mode, to 1e-4 (the same fp32 products summed in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines import BaselineEngine as JaxBaselineEngine
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.core.merge import apply_merge_weighted as jax_merge_weighted
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.ops.attention import causal_attention_chunked as jax_chunked
from framefusion_tpu.ops.kernels.sink_prefill import sink_flash_attention as jax_sink
from framefusion_tpu_torch.baselines import BaselineEngine, compute_density_overhead, replace_forward
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.core import apply_merge_weighted
from framefusion_tpu_torch.interface import FrameFusionModel
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.ops.attention import causal_attention_einsum
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.ops.kernels import sink_prefill as tsp
from framefusion_tpu_torch.ops.sampling import SamplerConfig
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from test_core import make_sequence

TOL = 1e-4


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=6)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tiny_llm_config(num_layers=6), jp, tq.params_from_numpy(jax.device_get(jp))


def prompt(n_frames: int, n_post: int = 3):
    """``tests/test_baselines``' prompt (4 text, 6 patches x ``n_frames``,
    ``n_post`` text): 10 frames and 3 give its 67 tokens, 20 and 4 give 128."""
    h, pt, img_start, n_img = make_sequence(np.random.default_rng(0), 4, 6, n_frames, n_post, hidden=128,
                                            coherent=0.7)
    return (h * 0.05).astype(np.float32), pt, np.arange(len(pt), dtype=np.int32), img_start, n_img


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


# -- the weighted merge ---------------------------------------------------------


def test_merge_weighted_hand_case():
    """tests/test_baselines' hand case: positions 1, 2 merge into 0, which
    already carries mass 2."""
    h = torch.tensor([[2.0, 0.0], [4.0, 0.0], [6.0, 0.0], [100.0, 1.0]])
    w = torch.tensor([2.0, 1.0, 1.0, 1.0])
    merged, new_w, keep = apply_merge_weighted(h, w, torch.tensor([False, True, True, False]), torch.arange(4))
    np.testing.assert_allclose(merged[0].numpy(), [3.5, 0.0], rtol=1e-6)  # (2*2 + 4 + 6) / 4
    np.testing.assert_allclose(new_w.numpy(), [4.0, 1.0, 1.0, 1.0])
    assert keep.tolist() == [True, False, False, True]


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_weighted_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s, d = 97, 16
    h = rng.standard_normal((s, d)).astype(np.float32)
    w = rng.integers(1, 5, s).astype(np.float32)
    order = rng.permutation(s).astype(np.int32)
    marked = rng.random(s) < 0.4
    marked[0] = False
    got = apply_merge_weighted(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(marked),
                               torch.from_numpy(order.astype(np.int64)))
    ref = jax_merge_weighted(jnp.asarray(h), jnp.asarray(w), jnp.asarray(marked), jnp.asarray(order))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


# -- sink attention -------------------------------------------------------------


def _qkv(seed, s, hq, hk, d=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in ((s, hq, d), (s, hk, d), (s, hk, d)))


@pytest.mark.parametrize("s,hq,hk,init_num,window", [
    (157, 2, 2, 8, 24),  # G = 1
    (157, 4, 2, 8, 1),  # the diagonal (and the sinks) only
    (203, 4, 2, 0, 24),  # no sink keys
    (203, 2, 1, 40, 24),  # init_num > window: sink and window tiles overlap
    (131, 4, 2, 8, 400),  # window >= S: plain causal attention
    (150, 4, 2, 8, 30),  # the window starts mid-tile
    (77, 4, 2, 0, 77),  # no sinks, window == S
])
def test_sink_attention_matches_jax(s, hq, hk, init_num, window):
    q, k, v = _qkv(s + init_num, s, hq, hk)
    tq_, tk, tv = map(torch.from_numpy, (q, k, v))
    ref_chunked = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sink=(init_num, window)))
    ref_pallas = np.asarray(jax_sink(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), init_num, window,
                                     block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(ref_pallas, ref_chunked, atol=TOL, rtol=TOL)
    for got in (tsp.sink_attn_fwd_plain(tq_, tk, tv, init_num, window),
                tsp.sink_flash_attention(tq_, tk, tv, init_num, window)):
        np.testing.assert_allclose(got.numpy(), ref_pallas, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("init_num,window", [(0, 10_000), (8, 100)])
def test_sink_plain_over_several_chunks_matches_jax(init_num, window):
    """More rows than one PLAIN_CHUNK; with the window over them all it is
    causal attention."""
    s = tfp.PLAIN_CHUNK + 77
    q, k, v = _qkv(4, s, 4, 2, d=16)
    got = tsp.sink_attn_fwd_plain(*map(torch.from_numpy, (q, k, v)), init_num, window)
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sink=(init_num, window))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    if window >= s:
        causal = causal_attention_einsum(*map(torch.from_numpy, (q, k, v)))
        np.testing.assert_allclose(got.numpy(), causal.numpy(), atol=TOL, rtol=TOL)


def test_sink_window_covering_everything_is_kernel_a():
    q, k, v = map(torch.from_numpy, _qkv(5, 190, 8, 2))
    np.testing.assert_allclose(tsp.sink_attn_fwd_plain(q, k, v, 8, 4096).numpy(),
                               tfp.flash_attn_fwd_plain(q, k, v)[0].numpy(), atol=TOL, rtol=TOL)


def test_sink_entry_point_clamps_like_jax():
    q, k, v = _qkv(6, 70, 2, 1)
    got = tsp.sink_flash_attention(*map(torch.from_numpy, (q, k, v)), -3, 0)
    ref = jax_sink(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), -3, 0, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError):
        tsp.sink_attn_fwd(*map(torch.from_numpy, (q, k, v)), 0, 0)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tsp.sink_attn_fwd(torch.zeros(4, 2, 128, device="meta"), torch.zeros(4, 1, 128, device="meta"),
                          torch.zeros(4, 1, 128, device="meta"), 0, 1)


# -- the five methods against JAX --------------------------------------------------

CASES = {
    "fastv": ("fastv", {"fastv_k": 2, "fastv_r": 0.5}, 10, 3),
    "fastv_k1": ("fastv", {"fastv_k": 1, "fastv_r": 0.3}, 10, 3),
    "streamingllm": ("streamingllm", {"init_num": 4, "length_rate": 0.5}, 20, 4),
    "streamingllm_init0": ("streamingllm", {"init_num": 0, "length_rate": 0.1}, 20, 4),
    "prefill_merge": ("prefill_merge", {"sparsity": [0.3, 0.2, 0.0, 0.1, 0.0, 0.0]}, 10, 3),
    # 247 tokens: the layer-0 merge drops a bucket, so the segments compact.
    "prefill_merge_compacts": ("prefill_merge", {"sparsity": [0.5, 0.3, 0.0, 0.2, 0.0, 0.0]}, 40, 3),
    "merge_then_fastv": ("merge_then_fastv", {"sparsity": [0.1] * 6, "fastv_k": 2, "fastv_r": 0.5}, 10, 3),
    "merge_then_fastv_compacts": ("merge_then_fastv", {"sparsity": [0.2] * 6, "fastv_k": 1, "fastv_r": 0.6}, 40, 3),
    "fastv_then_merge": ("fastv_then_merge", {"fastv_k": 2, "fastv_r": 0.75, "merging_sparsity": 0.3}, 10, 3),
    "fastv_then_merge_compacts": ("fastv_then_merge", {"fastv_k": 1, "fastv_r": 0.75, "merging_sparsity": 0.5}, 40, 3),
}


def run_pair(stacks, mode, kwargs, n_frames, n_post, attn_impl="flash"):
    jcfg, tcfg, jp, tp = stacks
    h, pt, pos, start, n_img = prompt(n_frames, n_post)
    eng_j = JaxBaselineEngine(jp, jcfg, mode, kwargs, attn_impl="einsum", bucket=32)
    eng_t = BaselineEngine(tp, tcfg, mode, kwargs, attn_impl=attn_impl, bucket=32)
    res_j = eng_j.prefill(h, pt, pos, 6, start, n_img)
    res_t = eng_t.prefill(h, pt, pos, 6, start, n_img)
    return eng_j, eng_t, res_j, res_t


def assert_same(eng_j, eng_t, res_j, res_t, n_new=5):
    assert events(res_t) == events(res_j)
    assert res_t.valid_len == res_j.valid_len
    assert res_t.telemetry.final_image_tokens == res_j.telemetry.final_image_tokens
    assert [c[2] for c in res_t.layer_caches] == [c[2] for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    for (kt, vt, n), (kj, vj, _) in zip(res_t.layer_caches, res_j.layer_caches):
        np.testing.assert_allclose(kt[:n].numpy(), np.asarray(kj[:n], np.float32), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(vt[:n].numpy(), np.asarray(vj[:n], np.float32), atol=TOL, rtol=TOL)
    assert eng_t.generate(res_t, n_new) == eng_j.generate_greedy(res_j, n_new)


@pytest.mark.parametrize("case", list(CASES))
def test_method_matches_jax(stacks, case):
    mode, kwargs, n_frames, n_post = CASES[case]
    eng_j, eng_t, res_j, res_t = run_pair(stacks, mode, kwargs, n_frames, n_post)
    assert res_t.mode == mode
    if mode != "streamingllm":
        assert res_t.valid_len < res_t.telemetry.original_length
    assert_same(eng_j, eng_t, res_j, res_t)


def test_streamingllm_einsum_route_matches_jax(stacks):
    """attn_impl="einsum" takes kernel F's plain version, not the kernel wrapper."""
    eng_j, eng_t, res_j, res_t = run_pair(stacks, "streamingllm", {"init_num": 8, "length_rate": 0.3}, 20, 4,
                                          attn_impl="einsum")
    launches = tsp.sink_attn_fwd.launches
    assert_same(eng_j, eng_t, res_j, res_t)
    assert tsp.sink_attn_fwd.launches == launches


def test_streamingllm_full_window_is_dense_at_a_padded_length(stacks):
    """67 tokens pad to 128: with a window over the whole prompt the sink
    mask is causal, so the first-token logits are the dense prefill's, read
    from the last live row (the JAX program reads a pad row here)."""
    _, tcfg, _, tp = stacks
    h, pt, pos, start, n_img = prompt(10, 3)
    eng = BaselineEngine(tp, tcfg, "streamingllm", {"init_num": 8, "length_rate": 100})
    res = eng.prefill(h, pt, pos, 6, start, n_img)
    dense = CompressionEngine(tp, tcfg, eng.ff).dense_prefill(h, pos)
    assert res.valid_len == dense.valid_len == len(pt) == 67
    np.testing.assert_allclose(res.logits.numpy(), dense.logits.numpy(), atol=TOL, rtol=TOL)
    assert eng.generate(res, 5) == eng.generate(dense, 5)


# -- the sink-cache decode ------------------------------------------------------

SINK = {"init_num": 4, "length_rate": 0.5, "sink_cache_decode": True}


@pytest.mark.parametrize("window_length,num_sink_tokens", [(24, 4), (9, 0)])
def test_sink_cache_decode_matches_jax(stacks, window_length, num_sink_tokens):
    kwargs = dict(SINK, window_length=window_length, num_sink_tokens=num_sink_tokens)
    eng_j, eng_t, res_j, res_t = run_pair(stacks, "streamingllm", kwargs, 20, 4)
    toks = eng_t.generate(res_t, 6)
    assert toks == eng_j.generate_greedy(res_j, 6)
    assert len(toks) == 6
    again, logits = eng_t.sink_cache_decode(res_t, 6)
    assert again == toks and logits.shape == (stacks[1].vocab_size,) and int(torch.argmax(logits)) == toks[-1]


def test_sink_cache_decode_over_the_whole_cache_is_full_decode(stacks):
    _, tcfg, _, tp = stacks
    h, pt, pos, start, n_img = prompt(20, 4)
    full = BaselineEngine(tp, tcfg, "streamingllm", {"init_num": 4, "length_rate": 0.5})
    win = BaselineEngine(tp, tcfg, "streamingllm", dict(SINK, window_length=10_000, num_sink_tokens=4))
    toks_full = full.generate(full.prefill(h, pt, pos, 6, start, n_img), 5)
    assert win.generate(win.prefill(h, pt, pos, 6, start, n_img), 5) == toks_full
    short = BaselineEngine(tp, tcfg, "streamingllm", dict(SINK, window_length=6, num_sink_tokens=2))
    assert short.generate(short.prefill(h, pt, pos, 6, start, n_img), 5) != toks_full


def test_sink_cache_decode_is_greedy_only(stacks):
    _, tcfg, _, tp = stacks
    h, pt, pos, start, n_img = prompt(20, 4)
    eng = BaselineEngine(tp, tcfg, "streamingllm", SINK)
    res = eng.prefill(h, pt, pos, 6, start, n_img)
    with pytest.raises(NotImplementedError):
        eng.generate(res, 4, sampler=SamplerConfig(temperature=0.7))
    assert eng.generate(res, 3, sampler=SamplerConfig()) == eng.generate(res, 3)


# -- the entry point --------------------------------------------------------------

ENTRY = {
    "fastv": {"fastv_k": 2, "fastv_r": 0.5},
    "streamingllm": {"init_num": 4, "length_rate": 0.5},
    "prefill_merge": {"sparsity": [0.2] * 6},
    "merge_then_fastv": {"sparsity": [0.1] * 6, "fastv_k": 2, "fastv_r": 0.5},
    "fastv_then_merge": {"fastv_k": 2, "fastv_r": 0.75, "merging_sparsity": 0.3},
    "sink_cache_decode": dict(SINK, window_length=24),
}


@pytest.mark.parametrize("name", list(ENTRY))
def test_replace_forward_runs_the_baseline_through_the_model(stacks, name):
    _, tcfg, _, tp = stacks
    h, pt, pos, start, n_img = prompt(20, 4)
    inputs = PrefillInputs(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6,
                           image_token_start=start, image_token_length=n_img)
    mode = "streamingllm" if name == "sink_cache_decode" else name
    model = replace_forward(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), mode, **ENTRY[name])
    assert model.ff is None and isinstance(model.engine(), BaselineEngine)
    toks, res = model.generate(inputs, max_new_tokens=4)
    assert res.mode == mode and res.telemetry.events  # the baseline ran, not the dense prefill
    eng = BaselineEngine(tp, tcfg, mode, ENTRY[name])
    ref = eng.prefill(h, pt, pos, 6, start, n_img)
    assert events(res) == events(ref) and res.valid_len == ref.valid_len
    assert toks == eng.generate(ref, 4)
    assert model.prefill(inputs).mode == mode


def test_unknown_mode_raises(stacks):
    _, tcfg, _, tp = stacks
    h, pt, pos, start, n_img = prompt(10, 3)
    with pytest.raises(NotImplementedError):
        BaselineEngine(tp, tcfg, "nope", {}).prefill(h, pt, pos, 6, start, n_img)
    inputs = PrefillInputs(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6,
                           image_token_start=start, image_token_length=n_img)
    with pytest.raises(NotImplementedError):
        replace_forward(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), "nope").prefill(inputs)


def test_compute_density_overhead():
    cost, rem = compute_density_overhead([0.0, 0.0, 0.0, 0.0])
    assert cost == pytest.approx(1.0) and rem == pytest.approx(1.0)
    cost, rem = compute_density_overhead([0.5, 0.5])
    assert rem == pytest.approx(0.25) and cost == pytest.approx((0.5 + 0.25) / 2)
