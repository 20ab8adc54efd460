"""PyTorch port vs the JAX package: the Qwen2 decoder stack.

One set of weights — ``framefusion_tpu.models.qwen2.init_params`` fetched as
numpy and carried over with ``params_from_numpy`` — and numpy inputs go
through both stacks at a tiny fp32 geometry. Values agree to 1e-4 (fp32 on
both sides, summed in different orders through several layers); where both
sides round activations and weights to bf16 for the decode matvecs, to 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.ops.quant import quantize_params_int8 as jax_quantize
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.models import qwen2 as tq

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 2e-3


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(num_layers=3)
    tcfg = tiny_llm_config(num_layers=3)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    # Non-zero biases so the bias path is exercised.
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        jp["layers"][name] = jnp.asarray(rng.standard_normal(jp["layers"][name].shape) * 0.02, jnp.float32)
    tp = tq.params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_init_params_layout_matches_jax(models):
    jcfg, tcfg, jp, _ = models
    tp = tq.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name, w in tp["layers"].items():
        assert tuple(w.shape) == jp["layers"][name].shape and w.dtype == torch.float32, name
    again = tq.init_params(tcfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])
    bf = tq.init_params(tcfg.replace(dtype=torch.bfloat16), torch.Generator().manual_seed(0))
    assert all(w.dtype == torch.bfloat16 for w in bf["layers"].values())


def test_params_from_numpy_carries_int8_pairs(models):
    jcfg, _, jp, _ = models
    jq8 = jax_quantize(jax.tree.map(jnp.copy, jp))
    tp8 = tq.params_from_numpy(jax.device_get(jq8), device="cpu")
    for name in ("wq", "w_down"):
        assert tp8["layers"][name]["q8"].dtype == torch.int8
        np.testing.assert_array_equal(tp8["layers"][name]["q8"].numpy(), np.asarray(jq8["layers"][name]["q8"]))
        np.testing.assert_array_equal(tp8["layers"][name]["scale"].numpy(), np.asarray(jq8["layers"][name]["scale"]))
    bf = tq.params_from_numpy({"w": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}, device="cpu")
    assert bf["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_layer_blocks_match_jax(models, impl):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    s = 40
    h = (rng.standard_normal((s, jcfg.hidden_size)) * 0.5).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kv = rng.random(s) > 0.3
    kv[0] = kv[-1] = True
    cos_j, sin_j = jq.positions_cos_sin(jnp.asarray(pos), jcfg)
    cos_t, sin_t = tq.positions_cos_sin(torch.from_numpy(pos), tcfg)
    lp_j = jq.layer_slice(jp["layers"], 1)
    lp_t = tq.layer_slice(tp["layers"], 1)
    hj, kj, vj, imp_j = jq.layer_attention(lp_j, jnp.asarray(h), cos_j, sin_j, jcfg, attn_impl="einsum",
                                          capture_num=1, valid_len=jnp.int32(s), key_valid=jnp.asarray(kv))
    ht, kt, vt, imp_t = tq.layer_attention(lp_t, torch.from_numpy(h), cos_t, sin_t, tcfg, attn_impl=impl,
                                          capture_num=1, valid_len=s, key_valid=torch.from_numpy(kv))
    live = np.cumsum(kv) > 0
    np.testing.assert_allclose(ht.numpy()[live], np.asarray(hj)[live], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(imp_t.numpy(), np.asarray(imp_j), atol=1e-6, rtol=TOL)
    np.testing.assert_allclose(tq.layer_mlp(lp_t, ht, tcfg).numpy(), np.asarray(jq.layer_mlp(lp_j, hj, jcfg)),
                               atol=TOL, rtol=TOL)


def test_int8_mm_matches_jax(models):
    jcfg, _, jp, _ = models
    jq8 = jax_quantize(jax.tree.map(jnp.copy, jp))
    tp8 = tq.params_from_numpy(jax.device_get(jq8), device="cpu")
    x = np.random.default_rng(2).standard_normal((5, jcfg.hidden_size)).astype(np.float32)
    w_j = jax.tree.map(lambda a: a[0], jq8["layers"]["wq"])
    w_t = {k: v[0] for k, v in tp8["layers"]["wq"].items()}
    np.testing.assert_allclose(tq.mm(torch.from_numpy(x), w_t).numpy(), np.asarray(jq.mm(jnp.asarray(x), w_j)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_dense_prefill_matches_jax(models, impl):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(3)
    s = 48
    emb = (rng.standard_normal((s, jcfg.hidden_size)) * 0.05).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    lj, kj, _ = jq.dense_prefill(jp, jnp.asarray(emb), jnp.asarray(pos), jcfg, attn_impl="einsum")
    lt, kt, _ = tq.dense_prefill(tp, torch.from_numpy(emb), torch.from_numpy(pos), tcfg, attn_impl=impl)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_matches_jax(models, quantized):
    """Port "einsum" vs JAX "jax" (plain projections), and port "flash"
    (gemv kernels' plain versions) vs JAX "mv-jax" (Pallas matvecs in
    interpret mode), both with a tail split of the pool."""
    jcfg, tcfg, jp, tp = models
    if quantized:
        jp = jax_quantize(jax.tree.map(jnp.copy, jp))
        tp = tq.params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(4)
    L, s_pool, hk, hd = jcfg.num_layers, 64, jcfg.num_kv_heads, jcfg.head_dim_
    k_pool = (rng.standard_normal((L, s_pool, hk, hd)) * 0.5).astype(np.float32)
    v_pool = (rng.standard_normal((L, s_pool, hk, hd)) * 0.5).astype(np.float32)
    lens = [50, 20, 20]
    emb = (rng.standard_normal(jcfg.hidden_size) * 0.05).astype(np.float32)
    for j_impl, t_impl, tol in (("jax", "einsum", TOL), ("mv-jax", "flash", BF16_TOL)):
        lj, kpj, _, _ = jq.decode_step(jp, jnp.asarray(emb), jnp.int32(51), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                       jnp.asarray(lens, jnp.int32), jcfg, attn_impl=j_impl, tail_split=(1, 32))
        kp_t = torch.from_numpy(k_pool.copy())
        lt, kp_t, _, new_lens = tq.decode_step(tp, torch.from_numpy(emb), 51, kp_t, torch.from_numpy(v_pool.copy()),
                                              lens, tcfg, attn_impl=t_impl, tail_split=(1, 32))
        assert new_lens == [51, 21, 21]
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol * float(np.abs(np.asarray(lj)).max()), rtol=0)
        np.testing.assert_allclose(kp_t.numpy(), np.asarray(kpj), atol=tol, rtol=tol)
