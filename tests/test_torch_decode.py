"""The port's decode side vs the JAX package: kernel G, the decode-step
variants, the batched and speculative-verify programs, the plain matvec
entry points, the loaders' device default, and the counterpart table.

Inputs are drawn with numpy from seeds and go through the JAX function and
its port; JAX weights carry over with ``params_from_numpy``. Tolerances:

* fp32 attention (kernel G's plain version against the Pallas kernel in
  interpret mode, ``verify_attention``) agrees to 1e-5: the same fp32 math
  summed in other orders, at O(1) magnitudes.
* Whole programs in fp32 (plain projections on both sides) agree to 1e-4
  of the largest logit, through several layers (as tests/test_torch_qwen2.py
  holds ``decode_step``); where both sides stream the projections through
  the matvec kernels, which round activations and weights to bf16, to 2e-3.
* The port against itself (a K-row program against K one-row programs, a
  batched program against solo ones) agrees to 1e-4: the same fp32 math
  over other shapes.
* The plain matvecs round to bf16 and sum in fp32 on both sides: 1e-5 of
  the output's largest magnitude.
* A device-tensor length or position against the host int: the same
  arithmetic on the same values, so bitwise equal.

The sampler draws its tokens by inverse CDF from uniforms drawn before the
decode: a valid sample, not ``jax.random``'s or ``torch.multinomial``'s
bits, so its tests check the kept set, determinism and the frequencies.
"""

import ast
import importlib
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import _siglip_state, write_fixture
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.ops.attention import verify_attention as jax_verify_attention
from framefusion_tpu.ops.kernels import matvec_q8 as jmv
from framefusion_tpu.ops.kernels.decode_attention import ragged_decode_attention as jax_ragged
from framefusion_tpu.ops.quant import quantize_params_int8 as jax_quantize
from framefusion_tpu_torch import weights
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.vision import siglip as tsiglip
from framefusion_tpu_torch.models.vision.siglip import tiny_vit_config
from framefusion_tpu_torch.ops import kernels as registry
from framefusion_tpu_torch.ops.attention import verify_attention
from framefusion_tpu_torch.ops.kernels import decode_attention as tda
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
from framefusion_tpu_torch.ops.sampling import SamplerConfig, draw_uniforms, filtered_probs, sample_token
from framefusion_tpu_torch.pipeline import TextPipeline

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

ATTN_TOL = 1e-5
TOL = 1e-4
BF16_TOL = 2e-3
MV_RTOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def assert_rel(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * float(np.abs(ref).max()))


# -- kernel G's plain version ------------------------------------------------


@pytest.mark.parametrize("s", [256, 200])  # 200: a pool that is not a multiple of the 128-key block
@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("length", [1, 100, 128, 129, "S"])
def test_ragged_decode_matches_pallas(s, g, length):
    length = s if length == "S" else length
    hk, d = 2, 128
    rng = np.random.default_rng(s + 10 * g)
    q = rng.standard_normal((hk * g, d)).astype(np.float32)
    k = rng.standard_normal((s, hk, d)).astype(np.float32)
    v = rng.standard_normal((s, hk, d)).astype(np.float32)
    got = tda.ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), length)
    ref = jax_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length), block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL, rtol=ATTN_TOL)
    assert torch.equal(got, tda.ragged_decode_attn_plain(torch.from_numpy(q), torch.from_numpy(k),
                                                         torch.from_numpy(v), length))


def test_ragged_decode_wrapper_validates():
    q, kc = torch.zeros(4, 128), torch.zeros(16, 2, 128)
    for bad_len in (0, 17):
        with pytest.raises(ValueError, match="cache_len"):
            tda.ragged_decode_attn(q, kc, kc, bad_len)
    with pytest.raises(ValueError, match="incompatible"):
        tda.ragged_decode_attn(torch.zeros(3, 128), kc, kc, 4)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tda.ragged_decode_attn(q.to("meta"), kc.to("meta"), kc.to("meta"), 4)
    launches = tda.ragged_decode_attn.launches
    tda.ragged_decode_attn(q, kc, kc, 4)
    assert tda.ragged_decode_attn.launches == launches  # the plain version on the CPU launches nothing


@pytest.mark.parametrize("hk", [4, 1])
@pytest.mark.parametrize("length", [1, 64, 65, 3293, 11698, 32768])
def test_ragged_decode_split_plan_covers_the_length(length, hk):
    keys, n_split = tda.split_plan(length, hk)
    # whole 64-key tiles, no CTA past the length, at most one wave of CTAs
    assert keys % tda.TILE_KEYS == 0 and (n_split - 1) * keys < length <= n_split * keys
    assert n_split * hk <= tda.SM_COUNT and 1 <= n_split <= tda.MAX_SPLIT
    # as few tiles a CTA as that allows: one tile fewer would take more than a wave
    tiles, per_cta = -(-length // tda.TILE_KEYS), keys // tda.TILE_KEYS
    assert per_cta == 1 or -(-tiles // (per_cta - 1)) * hk > tda.SM_COUNT


def _split_k(q, k, v, cache_len: int, max_len=None):
    """Kernel G's algebra in fp32: per split of the wrapper's plan (made for
    ``max_len``, the host-int launch's ``cache_len`` by default), each of
    the four warps' 16-key slices of every 64-key tile keeps (m, l, acc)
    in log2 units; the CTA merges its warps in warp order, then the splits
    merge in split order. A split past the length is an empty partial:
    m = -inf, l = 0, acc = 0."""
    hq, d = q.shape
    g = hq // k.shape[1]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    keys_per_split, n_split = tda.split_plan(max_len or cache_len, k.shape[1])
    kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)  # (S, Hq, D)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        m_ref = torch.where(torch.isinf(m), torch.zeros_like(m), m)  # no live key in any part: weights 0
        w = [torch.exp2(p[0] - m_ref) for p in parts]
        return m, sum(p[1] * wi for p, wi in zip(parts, w)), sum(p[2] * wi[:, None] for p, wi in zip(parts, w))

    splits = []
    for s in range(n_split):
        lo, hi = s * keys_per_split, min(cache_len, (s + 1) * keys_per_split)
        warps = []
        for w in range(4):
            idx = torch.tensor([n + w * 16 + j for n in range(lo, hi, tda.TILE_KEYS) for j in range(16)
                                if n + w * 16 + j < hi], dtype=torch.long)
            if idx.numel() == 0:  # a slice past the length: weight 0 in the merge
                warps.append((torch.full((hq,), -math.inf), torch.zeros(hq), torch.zeros(hq, d)))
                continue
            sc = torch.einsum("hd,nhd->hn", q, kx[idx]) * scale_log2
            m = sc.amax(-1)
            p = torch.exp2(sc - m[:, None])
            warps.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vx[idx])))
        splits.append(merge(warps))
    _, l, acc = merge(splits)
    return acc / l[:, None]


@pytest.mark.parametrize("length,hk,g", [(1, 4, 7), (65, 2, 8), (777, 1, 16), (3293, 4, 7), (11698, 4, 7)])
def test_ragged_decode_split_k_algebra_matches_plain(length, hk, g):
    rng = np.random.default_rng(length)
    q = torch.from_numpy(rng.standard_normal((hk * g, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((length + 37, hk, 128)).astype(np.float32)) for _ in range(2))
    assert_rel(_split_k(q, k, v, length), tda.ragged_decode_attn_plain(q, k, v, length).numpy(), ATTN_TOL)


@pytest.mark.parametrize("max_len,lengths", [(3328, [1, 63, 64, 65, 3293, 3328]), (11776, [1, 65, 11698])])
def test_ragged_decode_split_k_algebra_at_a_device_length(max_len, lengths):
    """A launch planned for ``max_len`` (as a captured graph's is) at
    shorter live lengths: the splits past the length merge as empty
    partials and the result is the plain version's."""
    rng = np.random.default_rng(max_len)
    q = torch.from_numpy(rng.standard_normal((28, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((max_len, 4, 128)).astype(np.float32)) for _ in range(2))
    for length in lengths:
        assert_rel(_split_k(q, k, v, length, max_len), tda.ragged_decode_attn_plain(q, k, v, length).numpy(),
                   ATTN_TOL)


@pytest.mark.parametrize("hk", [4, 1])
@pytest.mark.parametrize("max_len", [1, 63, 64, 65, 3293, 3328, 11698, 11776])
def test_ragged_decode_plan_for_max_len_covers_every_length(max_len, hk):
    """Every length in [1, max_len] lies inside the plan's splits, split 0
    always holds key 0, and no split starts past ``max_len``."""
    keys, n_split = tda.split_plan(max_len, hk)
    assert keys % tda.TILE_KEYS == 0 and (n_split - 1) * keys < max_len <= n_split * keys
    lengths = np.arange(1, max_len + 1)
    live_splits = -(-lengths // keys)  # splits holding a live key: the first ones, in order
    assert live_splits.min() == 1 and live_splits.max() == n_split and (live_splits <= n_split).all()


@pytest.mark.parametrize("length", [1, 17, 40])
def test_plain_ragged_decode_takes_a_tensor_length(length):
    rng = np.random.default_rng(length)
    q = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((48, 2, 128)).astype(np.float32)) for _ in range(2))
    want = tda.ragged_decode_attn_plain(q, k, v, length)
    for as_tensor in (torch.tensor(length), torch.tensor([length], dtype=torch.int32)):
        assert torch.equal(tda.ragged_decode_attn_plain(q, k, v, as_tensor), want)
        assert torch.equal(tda.ragged_decode_attention(q, k, v, as_tensor), want)
        assert torch.equal(tda.ragged_decode_attn(q, k, v, as_tensor), want)
    with pytest.raises(ValueError, match="one integer"):
        tda.ragged_decode_attn(q, k, v, torch.tensor([length, length]))
    with pytest.raises(ValueError, match="cache_len"):
        tda.ragged_decode_attn(q, k, v, 49)  # past the view


def test_verify_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 6, 32)).astype(np.float32)
    k = rng.standard_normal((40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((40, 2, 32)).astype(np.float32)
    got = verify_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 30)
    ref = jax_verify_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(30))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATTN_TOL, rtol=ATTN_TOL)


# -- the decode-side programs --------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(num_layers=3)
    tcfg = tiny_llm_config(num_layers=3)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):  # non-zero biases exercise the bias path
        jp["layers"][name] = jnp.asarray(rng.standard_normal(jp["layers"][name].shape) * 0.02, jnp.float32)
    jq8 = jax_quantize(jax.tree.map(jnp.copy, jp))
    return {False: (jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")),
            True: (jq8, tq.params_from_numpy(jax.device_get(jq8), device="cpu"))}, jcfg, tcfg


def _pools(rng, *lead, s=64, hk=2, hd=32):
    return tuple((rng.standard_normal((*lead, s, hk, hd)) * 0.5).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_ragged_matches_jax(models, quantized):
    """Port "ragged" against JAX "mv-jax" (JAX's "pallas" launches its kernel
    without interpret mode, which the CPU cannot run); on the CPU "ragged"
    is "flash" exactly (kernel G's wrapper takes the plain version)."""
    trees, jcfg, tcfg = models
    jp, tp = trees[quantized]
    rng = np.random.default_rng(4)
    k_pool, v_pool = _pools(rng, jcfg.num_layers)
    lens = [50, 20, 20]
    emb = (rng.standard_normal(jcfg.hidden_size) * 0.05).astype(np.float32)
    lj, kpj, vpj, _ = jq.decode_step(jp, jnp.asarray(emb), jnp.int32(51), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                     jnp.asarray(lens, jnp.int32), jcfg, attn_impl="mv-jax", tail_split=(1, 32))
    outs = {}
    for impl in ("ragged", "flash"):
        outs[impl] = tq.decode_step(tp, torch.from_numpy(emb), 51, torch.from_numpy(k_pool.copy()),
                                    torch.from_numpy(v_pool.copy()), lens, tcfg, attn_impl=impl, tail_split=(1, 32))
    lt, kpt, vpt, new_lens = outs["ragged"]
    assert new_lens == [51, 21, 21]
    assert_rel(lt, lj, BF16_TOL)
    np.testing.assert_allclose(kpt.numpy(), np.asarray(kpj), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(vpt.numpy(), np.asarray(vpj), atol=BF16_TOL, rtol=BF16_TOL)
    for a, b in zip(outs["ragged"][:3], outs["flash"][:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "flash", "ragged"])
@pytest.mark.parametrize("lens_dtype", [torch.int64, torch.int32])
def test_decode_step_device_state_equals_host_form(models, quantized, impl, lens_dtype):
    """Position and lengths as device tensors (the captured step's form):
    the same logits, pool rows and lengths, bit for bit."""
    trees, _, tcfg = models
    tp = trees[quantized][1]
    rng = np.random.default_rng(5)
    k_pool, v_pool = (torch.from_numpy(a) for a in _pools(rng, tcfg.num_layers))
    lens = [50, 20, 20]
    emb = torch.from_numpy((rng.standard_normal(tcfg.hidden_size) * 0.05).astype(np.float32))
    host = tq.decode_step(tp, emb, 51, k_pool.clone(), v_pool.clone(), lens, tcfg, attn_impl=impl,
                          tail_split=(1, 32))
    dev = tq.decode_step(tp, emb, torch.tensor(51), k_pool.clone(), v_pool.clone(),
                         torch.tensor(lens, dtype=lens_dtype), tcfg, attn_impl=impl, tail_split=(1, 32))
    for a, b in zip(host[:3], dev[:3]):
        assert torch.equal(a, b)
    assert host[3] == [51, 21, 21] and dev[3].dtype == torch.int64 and dev[3].tolist() == host[3]


def test_decode_step_rejects_unknown_impl(models):
    trees, _, tcfg = models
    with pytest.raises(ValueError, match="attn_impl"):
        tq.decode_step(trees[False][1], torch.zeros(tcfg.hidden_size), 0, torch.zeros(3, 8, 2, 32),
                       torch.zeros(3, 8, 2, 32), [0, 0, 0], tcfg, attn_impl="pallas")


BATCH_LENS = [[30, 25, 20], [20, 18, 10], [22, 12, 15]]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("split", [None, (1, 32, 40)])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_decode_step_batch_matches_jax(models, quantized, split, impl):
    trees, jcfg, tcfg = models
    jp, tp = trees[quantized]
    rng = np.random.default_rng(5)
    k_pool, v_pool = _pools(rng, jcfg.num_layers, 3)
    embs = (rng.standard_normal((3, jcfg.hidden_size)) * 0.05).astype(np.float32)
    pos = np.array([42, 37, 31], np.int32)
    j_impl = {"einsum": "jax", "flash": "pallas"}[impl]
    lj, kpj, vpj = jq.decode_step_batch(jp, jnp.asarray(embs), jnp.asarray(pos), jnp.asarray(k_pool),
                                        jnp.asarray(v_pool), jnp.asarray(BATCH_LENS, jnp.int32), jnp.int32(40),
                                        jnp.int32(2), jcfg, attn_impl=j_impl, tail_split=split)
    lt, kpt, vpt = tq.decode_step_batch(tp, torch.from_numpy(embs), pos, torch.from_numpy(k_pool.copy()),
                                        torch.from_numpy(v_pool.copy()), BATCH_LENS, 40, 2, tcfg, attn_impl=impl,
                                        tail_split=split)
    tol = TOL if impl == "einsum" else BF16_TOL
    assert_rel(lt, lj, tol)
    np.testing.assert_allclose(kpt.numpy(), np.asarray(kpj), atol=tol, rtol=tol)
    np.testing.assert_allclose(vpt.numpy(), np.asarray(vpj), atol=tol, rtol=tol)


def test_decode_step_batch_split_equals_full_read(models):
    """The two-segment read is the same math as the full padded read."""
    trees, _, tcfg = models
    tp = trees[False][1]
    rng = np.random.default_rng(6)
    k_pool, v_pool = _pools(rng, tcfg.num_layers, 3)
    embs = torch.from_numpy((rng.standard_normal((3, tcfg.hidden_size)) * 0.05).astype(np.float32))
    out = [tq.decode_step_batch(tp, embs, [42, 37, 31], torch.from_numpy(k_pool.copy()),
                                torch.from_numpy(v_pool.copy()), BATCH_LENS, 40, 3, tcfg, tail_split=split)[0]
           for split in (None, (1, 32, 40), (1, 40, 40))]  # the last one narrows nothing: no split
    assert_rel(out[1], out[0].numpy(), TOL)
    assert torch.equal(out[2], out[0])


@pytest.fixture
def verify_mv(monkeypatch):
    """Point the JAX verify programs at the streamed matvecs (interpret mode
    on the CPU), as the port's "flash" does."""
    def set_impl(impl):
        monkeypatch.setenv("FF_VERIFY_MV", "1" if impl == "flash" else "0")
    return set_impl


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_verify_step_matches_jax(models, verify_mv, quantized, impl):
    trees, jcfg, tcfg = models
    jp, tp = trees[quantized]
    verify_mv(impl)
    rng = np.random.default_rng(7)
    k_pool, v_pool = _pools(rng, jcfg.num_layers)
    lens = [40, 20, 18]
    rows = (rng.standard_normal((4, jcfg.hidden_size)) * 0.05).astype(np.float32)
    pos = np.arange(40, 44, dtype=np.int32)
    lj, kpj, _ = jq.verify_step(jp, jnp.asarray(rows), jnp.asarray(pos), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                jnp.asarray(lens, jnp.int32), jcfg, tail_split=(1, 32))
    lt, kpt, _ = tq.verify_step(tp, torch.from_numpy(rows), pos, torch.from_numpy(k_pool.copy()),
                                torch.from_numpy(v_pool.copy()), lens, tcfg, attn_impl=impl, tail_split=(1, 32))
    tol = TOL if impl == "einsum" else BF16_TOL
    assert lt.shape == (4, tcfg.vocab_size)
    assert_rel(lt, lj, tol)
    np.testing.assert_allclose(kpt.numpy(), np.asarray(kpj), atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_verify_step_equals_sequential_decode(models, impl):
    """Row i of the K-row program is the decode step after rows 0..i."""
    trees, _, tcfg = models
    tp = trees[False][1]
    rng = np.random.default_rng(8)
    k_pool, v_pool = _pools(rng, tcfg.num_layers)
    lens = [40, 20, 18]
    rows = torch.from_numpy((rng.standard_normal((4, tcfg.hidden_size)) * 0.05).astype(np.float32))
    lv, kv, _ = tq.verify_step(tp, rows, [40, 41, 42, 43], torch.from_numpy(k_pool.copy()),
                               torch.from_numpy(v_pool.copy()), lens, tcfg, attn_impl=impl)
    kp, vp, ln, seq = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy()), lens, []
    for i in range(4):
        lg, kp, vp, ln = tq.decode_step(tp, rows[i], 40 + i, kp, vp, ln, tcfg, attn_impl=impl)
        seq.append(lg)
    # "flash" rounds each matvec's input row to bf16: an fp32 last-bit
    # difference between the 4-row and 1-row products can flip a rounding.
    tol = TOL if impl == "einsum" else BF16_TOL
    assert_rel(lv, torch.stack(seq).numpy(), tol)
    np.testing.assert_allclose(kv.numpy(), kp.numpy(), atol=tol, rtol=tol)


def _batch_verify_inputs(seed, cfg):
    rng = np.random.default_rng(seed)
    k_pool, v_pool = _pools(rng, cfg.num_layers, 3)
    embs = (rng.standard_normal((3, 4, cfg.hidden_size)) * 0.05).astype(np.float32)
    pos = (np.array(BATCH_LENS[0])[:, None] + np.arange(4)[None]).astype(np.int32)
    mask = np.zeros((3, 64), bool)
    mask[:, 40:42] = True  # two committed decode rows from earlier steps
    return k_pool, v_pool, embs, pos, mask


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("split", [None, (1, 32, 40), "phys"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_verify_step_batch_matches_jax(models, verify_mv, quantized, split, impl):
    trees, jcfg, tcfg = models
    jp, tp = trees[quantized]
    verify_mv(impl)
    k_pool, v_pool, embs, pos, mask = _batch_verify_inputs(9, tcfg)
    kw_j, kw_t = {}, {}
    if split == "phys":
        # Layers >= 1 in a tail pool: prefix rows [0, 32) and the decode
        # region [40, 64) of the head pool at [32, 56).
        k_tail = np.concatenate([k_pool[1:, :, :32], k_pool[1:, :, 40:]], axis=2)
        v_tail = np.concatenate([v_pool[1:, :, :32], v_pool[1:, :, 40:]], axis=2)
        k_pool, v_pool = k_pool[:1], v_pool[:1]
        kw_j = dict(k_tail=jnp.asarray(k_tail), v_tail=jnp.asarray(v_tail), phys=(1, 32, 40))
        kw_t = dict(k_tail=torch.from_numpy(k_tail.copy()), v_tail=torch.from_numpy(v_tail.copy()), phys=(1, 32, 40))
    else:
        kw_j = kw_t = dict(tail_split=split)
    lj, kpj, _, ktj, _ = jq.verify_step_batch(
        jp, jnp.asarray(embs), jnp.asarray(pos), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(BATCH_LENS, jnp.int32), jnp.asarray(mask), jnp.int32(40), jnp.int32(1), jcfg, **kw_j)
    lt, kpt, _, ktt, _ = tq.verify_step_batch(
        tp, torch.from_numpy(embs), pos, torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy()),
        BATCH_LENS, torch.from_numpy(mask), 40, 1, tcfg, attn_impl=impl, **kw_t)
    tol = TOL if impl == "einsum" else BF16_TOL
    assert lt.shape == (3, 4, tcfg.vocab_size)
    assert_rel(lt, lj, tol)
    np.testing.assert_allclose(kpt.numpy(), np.asarray(kpj), atol=tol, rtol=tol)
    if split == "phys":
        np.testing.assert_allclose(ktt.numpy(), np.asarray(ktj), atol=tol, rtol=tol)


def test_verify_step_batch_equals_solo(models):
    """With no committed decode rows, each sequence of the batched program is
    the solo K-row program on its own cache."""
    trees, _, tcfg = models
    tp = trees[False][1]
    k_pool, v_pool, embs, pos, _ = _batch_verify_inputs(10, tcfg)
    lb = tq.verify_step_batch(tp, torch.from_numpy(embs), pos, torch.from_numpy(k_pool.copy()),
                              torch.from_numpy(v_pool.copy()), BATCH_LENS, torch.zeros((3, 64), dtype=torch.bool),
                              40, 0, tcfg, attn_impl="einsum")[0]
    for b in range(3):
        solo = tq.verify_step(tp, torch.from_numpy(embs[b]), pos[b], torch.from_numpy(k_pool[:, b].copy()),
                              torch.from_numpy(v_pool[:, b].copy()), [row[b] for row in BATCH_LENS], tcfg,
                              attn_impl="einsum")[0]
        assert_rel(lb[b], solo.numpy(), TOL)


# -- matvec_q8 / matvec_bf16 ---------------------------------------------------


@pytest.mark.parametrize("rows", [1, 3])
def test_plain_matvecs_match_pallas(rows):
    rng = np.random.default_rng(60 + rows)
    k, n = 512, 384
    x = jnp.asarray(rng.standard_normal((rows, k)) * 0.1, jnp.bfloat16)
    w8 = jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8)
    sc = jnp.asarray(rng.random(n).astype(np.float32) * 0.01 + 0.005)
    wbf = jnp.asarray(rng.standard_normal((k, n)) * 0.1, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = tmv.matvec_q8(xt, torch.from_numpy(np.array(w8)), torch.from_numpy(np.array(sc)))
    assert_rel(got, jmv.matvec_q8(x, w8, sc, interpret=True), MV_RTOL)
    got = tmv.matvec_bf16(xt, torch.from_numpy(np.asarray(wbf, np.float32)).to(torch.bfloat16))
    assert_rel(got, jmv.matvec_bf16(x, wbf, interpret=True), MV_RTOL)
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        tmv.matvec_bf16(xt, torch.zeros(2, k, n))


# -- the loaders put the model on the card by default -------------------------


def test_loaders_default_to_the_card(tmp_path, monkeypatch):
    path = write_fixture(tmp_path, "llava_video")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        weights.load_checkpoint(path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TextPipeline.from_checkpoint(path, tokenizer=object())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        weights.params_from_state_dict({}, tiny_llm_config())
    model = weights.load_checkpoint(path, device="cpu")
    assert model.params["embed"].device.type == "cpu" and model.vision["params"]["patch_kernel"].device.type == "cpu"


def test_converters_default_to_the_card(monkeypatch):
    """The JAX-pytree and HF SigLIP converters take the loaders' rule: the
    card when no device is given, which raises naming device="cpu" without
    one; with device="cpu" they convert on the CPU."""
    tree = {"layers": {"wq": np.ones((2, 4, 4), np.float32), "q8": np.ones((2, 3), np.int8)}}
    sd = _siglip_state(np.random.default_rng(0), "vision_model.")
    vcfg = tiny_vit_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tq.params_from_numpy(tree)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsiglip.params_from_hf(sd, vcfg)
    got = tq.params_from_numpy(tree, device="cpu")
    assert got["layers"]["wq"].device.type == "cpu" and got["layers"]["q8"].dtype == torch.int8
    vit = tsiglip.params_from_hf(sd, vcfg, device="cpu")
    assert vit["layers"]["wq"].shape == (2, 64, 64) and vit["patch_kernel"].device.type == "cpu"


# -- every TPU kernel has its counterpart ------------------------------------------


def _pallas_functions():
    """(file:line, name) of every top-level function in the JAX kernel files
    that reaches ``pl.pallas_call``, directly or through a function of its file."""
    found = []
    for path in sorted((REPO / "framefusion_tpu" / "ops" / "kernels").glob("*.py")):
        funcs = {n.name: n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef)}
        direct, calls = set(), {}
        for name, fn in funcs.items():
            calls[name] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "pallas_call":
                    direct.add(name)
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in funcs:
                    calls[name].add(node.func.id)
        reach, grew = set(direct), True
        while grew:
            grew = False
            for name, callees in calls.items():
                if name not in reach and callees & reach:
                    reach.add(name)
                    grew = True
        rel = path.relative_to(REPO).as_posix()
        found += [(f"{rel}:{funcs[n].lineno}", n) for n in reach]
    return found


def test_every_pallas_kernel_has_a_port_counterpart():
    found = _pallas_functions()
    assert len(found) >= 15
    for key, name in found:
        assert key in registry.COUNTERPARTS, f"{key} ({name}) has no counterpart in ops/kernels/__init__.py"
        assert registry.COUNTERPARTS[key][0] == name, key


def test_counterpart_table_points_at_real_code():
    for key, (name, kernel) in registry.COUNTERPARTS.items():
        path, line = key.rsplit(":", 1)
        defs = {n.lineno: n.name for n in ast.parse((REPO / path).read_text()).body if isinstance(n, ast.FunctionDef)}
        assert defs.get(int(line)) == name, key
        assert kernel in registry.KERNELS, key
    for kernel, (module, source) in registry.KERNELS.items():
        assert (REPO / source).exists(), source
        wrapper = getattr(importlib.import_module(f"framefusion_tpu_torch.ops.kernels.{module}"), kernel)
        assert isinstance(wrapper.launches, int), kernel
        assert registry.replaces(kernel), kernel
    assert registry.replaces("ragged_decode_attn") == ["framefusion_tpu/ops/kernels/decode_attention.py:79"]


# -- sampling -----------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [SamplerConfig(temperature=0.7, top_k=5), SamplerConfig(temperature=1.0, top_p=0.6),
                                 SamplerConfig(temperature=1.3, top_k=40, top_p=0.3),
                                 SamplerConfig(temperature=0.5)])
def test_inverse_cdf_sampler_keeps_to_the_filtered_set(cfg):
    """Every draw (the extreme uniforms included) is a token of the top-k /
    top-p set, the draws are the generator's (same seed, same tokens), and
    their frequencies follow the filtered probabilities."""
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(500).astype(np.float32) * 3)
    scaled = logits / cfg.temperature
    kept = torch.ones(500, dtype=torch.bool)
    if cfg.top_k is not None:
        kept &= scaled >= torch.topk(scaled, cfg.top_k).values[-1]
    if cfg.top_p is not None:  # the smallest head of the sorted distribution reaching top_p
        order = torch.argsort(scaled, descending=True)
        head = torch.cumsum(torch.softmax(scaled[order], -1), -1) < cfg.top_p
        n_head = min(int(head.sum()) + 1, 500)
        kept &= scaled >= scaled[order[n_head - 1]]
    probs = filtered_probs(logits, cfg)
    assert torch.equal(probs > 0, kept)
    u = torch.cat([torch.tensor([0.0, 1.0 - 2.0 ** -24]), draw_uniforms(2000, torch.Generator().manual_seed(1))])
    toks = torch.stack([sample_token(logits, cfg, u=x) for x in u])
    assert kept[toks].all()
    freq = torch.bincount(toks[2:], minlength=500).float() / 2000
    assert float((freq - probs).abs().max()) < 0.05
    again = [int(sample_token(logits, cfg, torch.Generator().manual_seed(3))) for _ in range(2)]
    assert again[0] == again[1]
    assert int(sample_token(logits, SamplerConfig(), u=u[0])) == int(torch.argmax(logits))
