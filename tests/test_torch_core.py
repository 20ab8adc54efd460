"""PyTorch port vs the JAX package: core compression functions and plain ops.

Inputs are made with numpy from a seed and go through both the JAX function
and its port. Decisions (orders, ranks, masks, counts) must be equal;
values are fp32 on both sides and agree to 1e-5 (the two frameworks sum in
different orders).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu import core as jcore
from framefusion_tpu.core import schedule as jschedule
from framefusion_tpu.ops import attention as jattn
from framefusion_tpu.ops import quant as jquant
from framefusion_tpu.ops import rope as jrope
from framefusion_tpu_torch import core as tcore
from framefusion_tpu_torch.core import schedule as tschedule
from framefusion_tpu_torch.ops import attention as tattn
from framefusion_tpu_torch.ops import quant as tquant
from framefusion_tpu_torch.ops import rope as trope
from framefusion_tpu_torch.ops.sampling import SamplerConfig, sample_token
from test_core import make_sequence

VAL_TOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def n(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _video(seed, coherent=0.6, n_pre=3, patch_num=5, n_frames=8, n_post=2, hidden=32):
    rng = np.random.default_rng(seed)
    h, pt, start, n_img = make_sequence(rng, n_pre, patch_num, n_frames, n_post, hidden=hidden, coherent=coherent)
    return h, pt.astype(np.int32), start, n_img, patch_num


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_similarity_merge_match_jax(seed):
    h, pt, _, _, patch_num = _video(seed)
    s = len(pt)
    valid = np.ones(s, bool)
    valid[-1] = False  # a padding slot
    order_j, nimg_j = jcore.order_by_patch(jnp.asarray(pt), jnp.asarray(valid), patch_num)
    order_t, nimg_t = tcore.order_by_patch(t(pt), t(valid), patch_num)
    np.testing.assert_array_equal(n(order_t), np.asarray(order_j))
    assert int(nimg_t) == int(nimg_j)

    sim_j = jcore.similarity_by_patch(jnp.asarray(h), jnp.asarray(pt), order_j, nimg_j)
    sim_t = tcore.similarity_by_patch(t(h), t(pt), order_t, nimg_t)
    np.testing.assert_allclose(n(sim_t), np.asarray(sim_j), atol=VAL_TOL)

    for k in (0, 7, int(np.sum(np.asarray(sim_j) >= 0.7))):
        marked_j = jcore.mark_topk(sim_j, jnp.int32(k))
        marked_t = tcore.mark_topk(sim_t, k)
        np.testing.assert_array_equal(n(marked_t), np.asarray(marked_j))
        merged_j, keep_j = jcore.apply_merge(jnp.asarray(h), marked_j, order_j)
        merged_t, keep_t = tcore.apply_merge(t(h), marked_t, order_t)
        np.testing.assert_array_equal(n(keep_t), np.asarray(keep_j))
        np.testing.assert_allclose(n(merged_t), np.asarray(merged_j), atol=VAL_TOL)


def test_descending_rank_ties_follow_lower_index():
    scores = np.array([0.5, 0.9, 0.5, 0.9, -np.inf, 0.1], np.float32)
    np.testing.assert_array_equal(n(tcore.descending_rank(t(scores))),
                                  np.asarray(jcore.descending_rank(jnp.asarray(scores))))


@pytest.mark.parametrize("seed", [0, 1])
def test_prune_and_compact_match_jax(seed):
    rng = np.random.default_rng(seed)
    s = 40
    imp = rng.random(s).astype(np.float32)
    valid = np.arange(s) < 35
    keep_j = jcore.prune_keep_mask(jnp.asarray(imp), jnp.int32(4), jnp.int32(25), jnp.int32(11), jnp.asarray(valid))
    keep_t = tcore.prune_keep_mask(t(imp), 4, 25, 11, t(valid))
    np.testing.assert_array_equal(n(keep_t), np.asarray(keep_j))

    arrays = {"h": rng.standard_normal((s, 3)).astype(np.float32), "patch_type": np.arange(s, dtype=np.int32)}
    n_keep = int(np.asarray(keep_j).sum())
    new_len = jcore.bucket_length(n_keep, 16)
    assert tcore.bucket_length(n_keep, 16) == new_len
    out_j, valid_j = jcore.compact_tokens(keep_j, new_len, jnp.int32(n_keep), {k: jnp.asarray(v) for k, v in arrays.items()})
    out_t, valid_t = tcore.compact_tokens(keep_t, new_len, n_keep, {k: t(v) for k, v in arrays.items()})
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))
    for k in arrays:
        np.testing.assert_array_equal(n(out_t[k]), np.asarray(out_j[k]))


@pytest.mark.parametrize("sparsity,cost,layers", [
    ([], 0.3, 28), ([0.3], 0.3, 28), ([0.25, 0.2], 0.4, 6), ([0.5, 0.1, 0.05], 0.3, 28), ([0.6], 0.4, 6),
])
def test_schedule_twins_match_jax(sparsity, cost, layers):
    host = tschedule.compute_pruning_ratio(sparsity, cost, layers)
    assert host == jschedule.compute_pruning_ratio(sparsity, cost, layers)
    arr = np.zeros(8, np.float32)
    arr[: len(sparsity)] = sparsity
    ratio_t, infeas_t = tschedule.compute_pruning_ratio_device(
        t(arr), torch.tensor(len(sparsity)), torch.tensor(cost, dtype=torch.float32), layers)
    ratio_j, infeas_j = jschedule.compute_pruning_ratio_device(
        jnp.asarray(arr), jnp.int32(len(sparsity)), jnp.float32(cost), layers)
    assert float(ratio_t) == host  # the device twin does the host twin's roundings
    assert float(ratio_t) == pytest.approx(float(ratio_j), abs=1e-7)
    assert bool(infeas_t) == bool(infeas_j) is False


def test_schedule_infeasible():
    with pytest.raises(tschedule.CostInfeasibleError):
        tschedule.compute_pruning_ratio([0.0, 0.0, 0.0], 0.05, 6)
    arr = torch.zeros(4)
    _, infeas = tschedule.compute_pruning_ratio_device(arr, torch.tensor(3), torch.tensor(0.05), 6)
    assert bool(infeas)


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    q = rng.standard_normal((5, 4, 32)).astype(np.float32)
    k = rng.standard_normal((5, 2, 32)).astype(np.float32)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), 32, 1e4)
    cos_t, sin_t = trope.rope_cos_sin(t(pos), 32, 1e4)
    np.testing.assert_allclose(n(cos_t), np.asarray(cos_j), atol=VAL_TOL)
    qj, kj = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    qt, kt = trope.apply_rope(t(q), t(k), cos_t, sin_t)
    np.testing.assert_allclose(n(qt), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(n(kt), np.asarray(kj), atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_jax(masked):
    rng = np.random.default_rng(1)
    s, hq, hk, d = 24, 4, 2, 16
    q = rng.standard_normal((s, hq, d)).astype(np.float32)
    k = rng.standard_normal((s, hk, d)).astype(np.float32)
    v = rng.standard_normal((s, hk, d)).astype(np.float32)
    kv = rng.random(s) > 0.3 if masked else None
    if masked:
        kv[0] = kv[-1] = True
    kv_j = jnp.asarray(kv) if masked else None
    kv_t = t(kv) if masked else None
    out_j = jattn.causal_attention_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_valid=kv_j)
    out_t = tattn.causal_attention_einsum(t(q), t(k), t(v), key_valid=kv_t)
    live = kv if masked else np.ones(s, bool)
    np.testing.assert_allclose(n(out_t)[live], np.asarray(out_j)[live], atol=VAL_TOL)
    for num in (1, 4):
        imp_j = jattn.last_rows_importance(jnp.asarray(q), jnp.asarray(k), num, jnp.int32(s - 2), key_valid=kv_j)
        imp_t = tattn.last_rows_importance(t(q), t(k), num, s - 2, key_valid=kv_t)
        np.testing.assert_allclose(n(imp_t), np.asarray(imp_j), atol=1e-6)
    dec_j = jattn.decode_attention(jnp.asarray(q[5]), jnp.asarray(k), jnp.asarray(v), jnp.int32(17))
    dec_t = tattn.decode_attention(t(q[5]), t(k), t(v), 17)
    np.testing.assert_allclose(n(dec_t), np.asarray(dec_j), atol=VAL_TOL)


def test_capture_rows_sentinel_when_few_live_rows():
    kv = torch.tensor([False, True, False, False, True, False])
    assert tattn.capture_rows(6, 4, None, kv).tolist() == [-1, -1, 1, 4]
    assert tattn.capture_rows(6, 2, 5, None).tolist() == [3, 4]


def test_quantize_matches_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((3, 16, 24)) * 0.02).astype(np.float32)
    wq_j = jquant.quantize_weight(jnp.asarray(w))
    wq_t = tquant.quantize_weight(t(w))
    np.testing.assert_array_equal(n(wq_t["q8"]), np.asarray(wq_j["q8"]))
    np.testing.assert_allclose(n(wq_t["scale"]), np.asarray(wq_j["scale"]), rtol=1e-7)
    dequant = n(wq_t["q8"]).astype(np.float32) * n(wq_t["scale"])[:, None, :]
    np.testing.assert_allclose(dequant, w, atol=float(np.abs(w).max()) / 127)


def test_greedy_and_sampled_tokens():
    logits = torch.tensor([0.1, 2.0, -1.0, 1.9])
    assert int(sample_token(logits, SamplerConfig())) == 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = int(sample_token(logits, SamplerConfig(temperature=1.0, top_k=2), gen))
        assert tok in (1, 3)


def test_port_imports_no_jax():
    code = ("import sys, framefusion_tpu_torch.interface, framefusion_tpu_torch.runtime.engine, "
            "framefusion_tpu_torch._build; assert 'jax' not in sys.modules, 'jax imported'")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
