"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as tests/test_kernels.py
does. Attention is compared on live rows (the Pallas kernels leave rows
whose keys are all masked undefined; the port gives 0) at fp32 to 1e-4
(both sum fp32 products in their own orders). The matvecs round the
activation and weights to bf16 on both sides and accumulate in fp32, so
they agree to fp32 rounding: 1e-5 of the output's largest magnitude (sums
of +-127 int8 weights cancel, so an element-wise relative bound is not
meaningful).

Tests marked ``gpu`` hold each CUDA kernel against its plain version on a
card (``python -m pytest -m gpu tests/test_torch_kernels.py`` there); here
they skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.ops.kernels import flash_prefill as jfp
from framefusion_tpu.ops.kernels import matvec_q8 as jmv
from framefusion_tpu_torch import _build
from framefusion_tpu_torch.ops.attention import capture_rows
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
from framefusion_tpu_torch.ops.kernels import sink_prefill as tsp

ATTN_TOL = 1e-4
MV_RTOL = 1e-5


def to_t(a):
    """JAX/numpy array -> torch tensor of the same precision (bf16 via fp32, exact)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def assert_mv_close(got, ref, rtol=MV_RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def _qkv(seed, s, hq, hk, d=128):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in ((s, hq, d), (s, hk, d), (s, hk, d)))


@pytest.mark.parametrize("s,hq,hk,masked", [(256, 4, 2, False), (401, 4, 1, True), (256, 2, 2, True)])
def test_flash_attention_matches_pallas(s, hq, hk, masked):
    q, k, v = _qkv(s, s, hq, hk)
    kv = None
    if masked:
        kv = np.random.default_rng(7).random(s) > 0.4
        kv[0] = kv[-1] = True
    got = tfp.flash_causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                     key_valid=None if kv is None else torch.from_numpy(kv))
    ref = jfp.flash_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     key_valid=None if kv is None else jnp.asarray(kv),
                                     block_q=128, block_k=128, interpret=True)
    live = np.ones(s, bool) if kv is None else np.cumsum(kv) > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live], atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("num,masked", [(1, False), (1, True), (4, True), (4, False)])
def test_importance_matches_pallas(num, masked):
    s, hq, hk = 320, 4, 2
    q, k, v = _qkv(11 + num, s, hq, hk)
    kv = None
    valid_len = s - 5
    if masked:
        kv = np.random.default_rng(num).random(s) > 0.5
        kv[0] = True
        kv[-3:] = False  # trailing dead rows: capture rows come from live rank
        valid_len = s
    out_t, imp_t = tfp.flash_causal_attention_importance(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid_len, num,
        key_valid=None if kv is None else torch.from_numpy(kv))
    out_j, imp_j = jfp.flash_causal_attention_importance(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(valid_len), num,
        key_valid=None if kv is None else jnp.asarray(kv), block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(imp_t.numpy(), np.asarray(imp_j), atol=1e-6, rtol=ATTN_TOL)
    live = np.ones(s, bool) if kv is None else np.cumsum(kv) > 0
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live], atol=ATTN_TOL, rtol=ATTN_TOL)


def test_attention_stats_describe_the_softmax():
    q, k, v = _qkv(3, 64, 4, 2)
    kv = torch.ones(64, dtype=torch.bool)
    kv[:5] = False
    out, m, l = tfp.flash_attn_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv)
    assert torch.all(out[:5] == 0) and torch.all(l[:, :5] == 0) and torch.all(torch.isinf(m[:, :5]))
    rows = capture_rows(64, 2, None, kv)
    imp = tfp.attn_importance_rows(torch.from_numpy(q), torch.from_numpy(k), rows, m, l, kv)
    # each capture row's softmax sums to 1 over its keys, per head
    assert float(imp.sum()) == pytest.approx(1.0, abs=1e-5)
    assert torch.all(imp[:5] == 0)


def _stack(rng, dtype, l, k, n):
    if dtype == "int8":
        return jnp.asarray(rng.integers(-127, 128, (l, k, n)), jnp.int8)
    return jnp.asarray(rng.standard_normal((l, k, n)) * 0.1, jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("rows", [1, 3])
def test_matvec_stacked_and_qkv_match_pallas(dtype, rows):
    rng = np.random.default_rng(40 + rows)
    L, k = 3, 512
    wq, wk, wv = _stack(rng, dtype, L, k, 512), _stack(rng, dtype, L, k, 128), _stack(rng, dtype, L, k, 128)
    x = jnp.asarray(rng.standard_normal((rows, k)) * 0.1, jnp.bfloat16)
    for l in (0, L - 1):
        got = tmv.matvec_stacked(to_t(x), to_t(wq), l)
        ref = jmv.matvec_stacked(x, wq, l, interpret=True)
        assert_mv_close(got, ref)
        got3 = tmv.matvec_stacked_qkv(to_t(x), to_t(wq), to_t(wk), to_t(wv), l)
        ref3 = jmv.matvec_stacked_qkv(x, wq, wk, wv, l, interpret=True)
        for g, r in zip(got3, ref3):
            assert_mv_close(g, r)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_matvec_gateup_matches_pallas(dtype):
    rng = np.random.default_rng(50)
    L, k, n = 3, 512, 768
    wg, wu = _stack(rng, dtype, L, k, n), _stack(rng, dtype, L, k, n)
    if dtype == "int8":
        sg = jnp.asarray(rng.random((L, n)).astype(np.float32) * 0.01 + 0.005)
        su = jnp.asarray(rng.random((L, n)).astype(np.float32) * 0.01 + 0.005)
        sg_t, su_t = to_t(sg), to_t(su)
    else:
        sg = su = jnp.ones((1, n), jnp.float32)
        sg_t = su_t = None
    x = jnp.asarray(rng.standard_normal((2, k)) * 0.1, jnp.bfloat16)
    for l in (0, L - 1):
        got = tmv.matvec_stacked_gateup(to_t(x), to_t(wg), to_t(wu), sg_t, su_t, l)
        ref = jmv.matvec_stacked_gateup(x, wg, wu, sg, su, l, interpret=True)
        assert_mv_close(got, ref)


def test_float_weights_are_read_as_bf16():
    """A float weight stack goes through the kernel's bf16 read, as in JAX."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((2, 64, 32)).astype(np.float32)
    x = rng.standard_normal((1, 64)).astype(np.float32)
    got = tmv.matvec_stacked(torch.from_numpy(x), torch.from_numpy(w), 1)
    ref = jmv.matvec_stacked(jnp.asarray(x), jnp.asarray(w), 1, block_k=64, block_n=32, interpret=True)
    assert_mv_close(got, ref)


@pytest.mark.parametrize("call", [
    lambda d: tfp.flash_attn_fwd(torch.zeros(4, 2, 128, device=d), torch.zeros(4, 1, 128, device=d),
                                 torch.zeros(4, 1, 128, device=d)),
    lambda d: tmv.gemv_stacked(torch.zeros(1, 8, device=d), [torch.zeros(2, 8, 16, device=d)], 0),
    lambda d: tmv.gemv_gateup(torch.zeros(1, 8, device=d), torch.zeros(2, 8, 16, device=d),
                              torch.zeros(2, 8, 16, device=d), None, None, 0),
])
def test_wrappers_raise_off_cpu_and_cuda(call):
    with pytest.raises(RuntimeError, match="no kernel for device"):
        call("meta")


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError):
        tfp.flash_attn_fwd(torch.zeros(4, 3, 128), torch.zeros(4, 2, 128), torch.zeros(4, 2, 128))
    with pytest.raises(ValueError):
        tmv.gemv_stacked(torch.zeros(65, 8), [torch.zeros(2, 8, 16)], 0)
    with pytest.raises(IndexError):
        tmv.gemv_stacked(torch.zeros(1, 8), [torch.zeros(2, 8, 16)], 2)


def test_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first == _build.library_path() and first.parent == _build.BUILD_DIR
    for src in _build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _build.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,masked,hq,hk", [(200, False, 8, 2), (517, True, 8, 2), (300, True, 4, 4)])
def test_cuda_attention_kernels_match_plain(cuda, s, masked, hq, hk):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((s, hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = (torch.rand((s,), generator=gen, device=cuda) > 0.4) if masked else None
    out, m, l = tfp.flash_attn_fwd(q, k, v, kv)
    out_p, m_p, l_p = tfp.flash_attn_fwd_plain(q, k, v, kv)
    # per (row, head), relative to that row's own largest output: late rows
    # are much smaller than early ones, so a whole-tensor bound would miss
    # errors there (bf16 outputs and probabilities: a few ulps)
    err = (out.float() - out_p.float()).abs().amax(-1)
    assert (err <= 2e-2 * out_p.float().abs().amax(-1)).all()
    for num in (1, 4):
        rows = capture_rows(s, num, s, kv, device=cuda)
        imp = tfp.attn_importance_rows(q, k, rows, m, l, kv)
        imp_p = tfp.attn_importance_rows_plain(q, k, rows, m, l, kv)
        assert (imp - imp_p).abs().max() <= 1e-4 * imp_p.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_cuda_gemv_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def stack(n):
        w = torch.randn((3, 1024, n), generator=gen, device=cuda)
        return (w * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(torch.bfloat16)

    x = torch.randn((2, 1024), generator=gen, device=cuda).to(torch.bfloat16)
    stacks = [stack(1024), stack(256), stack(256)]
    for got, ref in zip(tmv.gemv_stacked(x, stacks, 2), tmv.gemv_stacked_plain(x, stacks, 2)):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    sg = torch.rand((3, 1024), generator=gen, device=cuda) if dtype == torch.int8 else None
    wu = stack(1024)
    got = tmv.gemv_gateup(x, stacks[0], wu, sg, sg, 1)
    ref = tmv.gemv_gateup_plain(x, stacks[0], wu, sg, sg, 1)
    assert got.shape == (2, 1024) and (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("s,hq,hk,init_num,window", [
    (200, 4, 4, 8, 24),  # G = 1
    (333, 28, 4, 8, 1),  # the diagonal and the sinks only
    (301, 14, 2, 0, 50),  # no sink keys
    (517, 28, 4, 100, 30),  # init_num > window: sink and window tiles overlap
    (190, 28, 4, 8, 4096),  # window >= S: causal attention, as kernel A
])
def test_cuda_sink_kernel_matches_plain(cuda, s, hq, hk, init_num, window):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((s, hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    launches = tsp.sink_attn_fwd.launches
    out = tsp.sink_attn_fwd(q, k, v, init_num, window)
    assert tsp.sink_attn_fwd.launches == launches + 1
    refs = [tsp.sink_attn_fwd_plain(q, k, v, init_num, window)]
    if window >= s:
        refs.append(tfp.flash_attn_fwd(q, k, v)[0])
    for ref in refs:  # per (row, head), relative to the row's largest output, as for kernel A
        err = (out.float() - ref.float()).abs().amax(-1)
        assert (err <= 2e-2 * ref.float().abs().amax(-1)).all()
