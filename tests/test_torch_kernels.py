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
from framefusion_tpu_torch.ops.kernels import decode_attention as tda
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
from framefusion_tpu_torch.ops.kernels import sink_prefill as tsp
from framefusion_tpu_torch.runtime.decode_graph import capture_graph

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

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
@pytest.mark.parametrize("rows", [1, 3, 8, 20])
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
@pytest.mark.parametrize("rows", [1, 2, 8, 20])
def test_matvec_gateup_matches_pallas(dtype, rows):
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
    x = jnp.asarray(rng.standard_normal((rows, k)) * 0.1, jnp.bfloat16)
    for l in (0, L - 1):
        got = tmv.matvec_stacked_gateup(to_t(x), to_t(wg), to_t(wu), sg_t, su_t, l)
        ref = jmv.matvec_stacked_gateup(x, wg, wu, sg, su, l, interpret=True)
        assert_mv_close(got, ref)


@pytest.mark.parametrize("rows", [1, 20])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k,ns", [(3584, [3584, 512, 512]), (3584, [3584]), (18944, [3584])])  # qkv, wo, w_down
def test_gemv_split_plan_fills_one_wave(k, ns, int8, rows):
    """At the decode projections' shapes the plan covers K exactly once, and
    its column tiles times K-chunks put at least one CTA on every SM and
    stay within one wave of ``CTAS_PER_SM`` CTAs an SM: at one row (512-byte
    tiles) and at 2-64 (256-column tiles), where the rows share each CTA
    and do not enter the plan."""
    tiles = tmv.column_tiles(ns, int8, rows)
    chunks, kchunk = tmv.split_plan(k, tiles)
    assert chunks * kchunk >= k > (chunks - 1) * kchunk
    assert kchunk % tmv.ROW_STEP == 0 and kchunk <= tmv.MAX_KCHUNK
    assert tmv.SM_COUNT <= tiles * chunks <= tmv.SM_COUNT * tmv.CTAS_PER_SM


@pytest.mark.parametrize("k,tiles,slots", [(8, 1, 1), (1003, 4, 3), (3584, 18, 64), (18944, 148, 1), (100000, 1, 1)])
def test_gemv_split_plan_covers_k(k, tiles, slots):
    """Any shape and any count of routed group slots: whole K-chunks of at
    most ``MAX_KCHUNK`` rows cover K, the last one not empty, and at most
    twice the fewest chunks that keep one wave (or that ``MAX_KCHUNK``
    forces)."""
    chunks, kchunk = tmv.split_plan(k, tiles, slots)
    assert chunks * kchunk >= k > (chunks - 1) * kchunk
    assert 0 < kchunk <= tmv.MAX_KCHUNK and kchunk % tmv.ROW_STEP == 0
    assert chunks <= 2 * max(1, tmv.SM_COUNT * tmv.CTAS_PER_SM // (tiles * slots), -(-k // tmv.MAX_KCHUNK))


@pytest.mark.parametrize("int8,chunks", [(False, 3), (True, 3)])
def test_gemv_split_plan_fills_its_last_wave(int8, chunks):
    """Kernel D's gate-up pass (K 3,584, two stacks of 18,944) needs more
    than one wave in bf16 (148 tiles, two K-chunks at the most rows a CTA
    stages): three chunks fill two waves better than two chunks fill
    1.12 (and int8's 74 tiles fit three chunks in one wave)."""
    tiles = tmv.column_tiles([18944, 18944], int8)
    assert tmv.split_plan(3584, tiles)[0] == chunks


@pytest.mark.parametrize("k", [1003, 1008])
def test_rows_operand_pads_k_to_a_multiple_of_8(k):
    """At 2-64 rows the kernel copies 8-value pieces of each activation row:
    a K off 8 is padded with zeros (the values kept), a K on 8 passes as it
    is, and one row passes as it is whatever its K."""
    x = torch.randn((3, k), generator=torch.Generator().manual_seed(k)).to(torch.bfloat16)
    xr, ldx = tmv._rows_operand(x)
    assert ldx == -(-k // 8) * 8 and xr.shape == (3, ldx)
    assert torch.equal(xr[:, :k], x) and not xr[:, k:].any()
    assert (xr is x) == (k % 8 == 0)
    one, ld1 = tmv._rows_operand(x[:1])
    assert one.data_ptr() == x.data_ptr() and ld1 == k


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


def _key_valid(s, gen, device):
    """Random live keys (60%) with rows 0-2 seeing none, a wholly dead
    128-key tile of kernel A (keys 128-255) and a wholly live one (keys
    256-383)."""
    kv = torch.rand((s,), generator=gen, device=device) > 0.4
    kv[:3] = False
    kv[128:256] = False
    kv[256:384] = True
    return kv


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hq,hk", [(4, 4), (28, 4)])  # G = 1 and 7
@pytest.mark.parametrize("s", [1, 64, 129, 517])
def test_cuda_flash_attn_matches_plain(cuda, s, hq, hk, masked):
    """Kernel A against its plain version: outputs per (row, head) within a
    few bf16 ulps of the row's largest (bf16 probabilities and outputs), the
    fp32 row statistics within 1e-3, rows with every key masked 0 with
    m = -inf and l = 0; and kernel B's importance from A's m (natural-log
    units) and l against B's plain version from the plain m and l (fp32 sums
    in other orders and ex2 against exp: 1e-3 of the largest importance)."""
    gen = torch.Generator(device=cuda).manual_seed(s + hq)
    q = torch.randn((s, hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = _key_valid(s, gen, cuda) if masked else None
    launches = tfp.flash_attn_fwd.launches
    out, m, l = tfp.flash_attn_fwd(q, k, v, kv)
    assert tfp.flash_attn_fwd.launches == launches + 1
    out_p, m_p, l_p = tfp.flash_attn_fwd_plain(q, k, v, kv)
    err = (out.float() - out_p.float()).abs().amax(-1)
    assert (err <= 2e-2 * out_p.float().abs().amax(-1)).all()
    fin = torch.isfinite(m_p)
    assert torch.equal(torch.isfinite(m), fin)
    assert ((m - m_p)[fin].abs() <= 1e-3).all() and ((l - l_p)[fin].abs() <= 1e-3 * l_p[fin]).all()
    if masked:  # rows 0-2 see no live key
        assert (out[:3] == 0).all() and (l[:, :3] == 0).all() and (m[:, :3] == float("-inf")).all()
    rows = capture_rows(s, min(4, s), s, kv, device=cuda)
    imp = tfp.attn_importance_rows(q, k, rows, m, l, kv)
    imp_p = tfp.attn_importance_rows_plain(q, k, rows, m_p, l_p, kv)
    assert (imp - imp_p).abs().max() <= 1e-3 * imp_p.abs().max()


@pytest.mark.gpu
def test_cuda_flash_attn_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((64, 8, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((64 * 2 * 128 + 1,), dtype=torch.bfloat16, device=cuda)[1:].view(64, 2, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfp.flash_attn_fwd(q, k, k)
    with pytest.raises(TypeError):
        tfp.flash_attn_fwd(q.float(), q.float()[:, :2], q.float()[:, :2])
    with pytest.raises(ValueError, match="head_dim"):
        tfp.flash_attn_fwd(q[..., :64], q[:, :2, :64], q[:, :2, :64])


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
    # the edges of F's 128-key tiles and of its warpgroups' 64 rows
    (700, 28, 4, 8, 127),
    (700, 28, 4, 8, 128),
    (700, 28, 4, 8, 129),
    (700, 4, 4, 0, 129),  # G = 1, no sink keys
    (645, 28, 4, 128, 200),  # the sinks fill tile 0 exactly
    (645, 28, 4, 129, 200),  # one sink key in tile 1
    (300, 28, 4, 400, 10),  # init_num >= S: causal attention
    (1000, 28, 4, 8, 1000),  # window == S off the tile: causal attention, as kernel A
    (11776, 28, 4, 8, 3501),  # the StreamingLLM prefill's bucket length
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


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hk", [(28, 4), (4, 4), (16, 8)])  # G = 7, 1, and more KV heads than warps
@pytest.mark.parametrize("rows", ["num=1", "num=4", "sentinel"])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_importance_kernel_matches_plain(cuda, masked, rows, hq, hk):
    """Kernel B at S off its 32-key tile, from kernel A's statistics: fp32
    sums in another order (ex2 against exp), 1e-4 of the largest importance."""
    s = 1000
    gen = torch.Generator(device=cuda).manual_seed(hq + hk)
    q = torch.randn((s, hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = _key_valid(s, gen, cuda) if masked else None
    _, m, l = tfp.flash_attn_fwd(q, k, k, kv)
    if rows == "sentinel":  # two absent rows, then the last two live rows
        live = torch.nonzero(kv).flatten() if masked else torch.arange(s, device=cuda)
        picked = torch.cat([torch.full((2,), -1, device=cuda), live[-2:]])
    else:
        picked = capture_rows(s, int(rows[-1]), s, kv, device=cuda)
    launches = tfp.attn_importance_rows.launches
    imp = tfp.attn_importance_rows(q, k, picked, m, l, kv)
    assert tfp.attn_importance_rows.launches == launches + 1
    imp_p = tfp.attn_importance_rows_plain(q, k, picked, m, l, kv)
    assert imp.shape == (s,) and (imp - imp_p).abs().max() <= 1e-4 * imp_p.abs().max()
    if masked:
        assert (imp[~kv] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("num", [1, 4])
def test_cuda_importance_is_repeatable(cuda, num):
    """Two calls give the same bits, and so do three replays of a captured
    call: the sum over rows and heads has a fixed order (no atomics)."""
    s, hq, hk = 6528, 28, 4
    gen = torch.Generator(device=cuda).manual_seed(num)
    q = torch.randn((s, hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = torch.rand((s,), generator=gen, device=cuda) > 0.45
    _, m, l = tfp.flash_attn_fwd(q, k, k, kv)
    rows = capture_rows(s, num, s, kv, device=cuda)
    first = tfp.attn_importance_rows(q, k, rows, m, l, kv)
    assert torch.equal(tfp.attn_importance_rows(q, k, rows, m, l, kv), first)
    # warmed up, then captured, on the capture stream (which then owns its arrival counters)
    held = {}
    graph = capture_graph(lambda: held.update(out=tfp.attn_importance_rows(q, k, rows, m, l, kv)), cuda)
    out = held["out"]
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


@pytest.mark.gpu
@pytest.mark.parametrize("length,s_view,hq,hk", [
    (11698, 11776, 28, 4),  # the phase layers of the 64-frame decode pool
    (3293, 3328, 28, 4),  # a tail layer's view
    (1, 512, 28, 4),  # one key
    (512, 512, 28, 4),  # every row of the view
    (65, 200, 28, 4),  # a length off the 64-key tile
    (517, 600, 4, 4),  # G = 1
    (777, 800, 16, 1),  # G = 16, the most the kernel takes
    (1000, 1024, 16, 2),  # G = 8
    (3000, 3072, 8, 4),  # G = 2
])
def test_cuda_ragged_decode_kernel_matches_plain(cuda, length, s_view, hq, hk):
    gen = torch.Generator(device=cuda).manual_seed(length)
    q = torch.randn((hq, 128), generator=gen, device=cuda).to(torch.bfloat16)
    pool = torch.randn((2, s_view, hk, 128), generator=gen, device=cuda).to(torch.bfloat16)
    launches = tda.ragged_decode_attn.launches
    out = tda.ragged_decode_attention(q, pool[0], pool[1], length)
    assert tda.ragged_decode_attn.launches == launches + 1
    ref = tda.ragged_decode_attn_plain(q, pool[0], pool[1], length)
    # per head, relative to that head's largest output: fp32 sums in other
    # orders, both rounded to bf16 once
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 2e-2 * ref.float().abs().amax(-1)).all()
    with pytest.raises(TypeError):
        tda.ragged_decode_attn(q.float(), pool[0], pool[1], length)
    with pytest.raises(ValueError, match="contiguous"):
        tda.ragged_decode_attn(q, pool[0].repeat(1, 2, 1)[:, :hk], pool[1], length)  # a strided head slice


@pytest.mark.gpu
@pytest.mark.parametrize("length", [5555, 1])  # split over many CTAs, and one CTA
def test_cuda_ragged_decode_is_repeatable(cuda, length):
    """Two calls give the same bits, and so do replays of a captured call:
    the last CTA of each KV head merges the splits in split order, whichever
    arrives last, and leaves the arrival counters at zero."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((28, 128), generator=gen, device=cuda).to(torch.bfloat16)
    pool = torch.randn((2, 6000, 4, 128), generator=gen, device=cuda).to(torch.bfloat16)
    first = tda.ragged_decode_attn(q, pool[0], pool[1], length)
    assert torch.equal(tda.ragged_decode_attn(q, pool[0], pool[1], length), first)
    # warmed up, then captured, on the capture stream (which then owns its arrival counters)
    held = {}
    graph = capture_graph(lambda: held.update(out=tda.ragged_decode_attn(q, pool[0], pool[1], length)), cuda)
    out = held["out"]
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert torch.equal(tda.ragged_decode_attn(q, pool[0], pool[1], length), first)
    torch.cuda.synchronize()
    assert all(int(buf.abs().sum()) == 0 for buf in tda._COUNTERS.values())


@pytest.mark.gpu
def test_cuda_ragged_decode_reads_its_length_from_the_device(cuda):
    """One captured launch with a device length, planned for the view's
    11,776 rows, replayed at lengths 1 to 11,698 without recapture: each
    within the per-head bound of the plain version, the same bits over two
    replays, the arrival counters back at zero; a length outside [1,
    11,776] gives NaN rows."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((28, 128), generator=gen, device=cuda).to(torch.bfloat16)
    pool = torch.randn((2, 11776, 4, 128), generator=gen, device=cuda).to(torch.bfloat16)
    length = torch.ones((), dtype=torch.int64, device=cuda)
    held = {}
    graph = capture_graph(lambda: held.update(out=tda.ragged_decode_attn(q, pool[0], pool[1], length)), cuda)
    out = held["out"]
    for n in (1, 63, 64, 65, 3293, 11698):
        length.fill_(n)
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first), n
        ref = tda.ragged_decode_attn_plain(q, pool[0], pool[1], n)
        err = (out.float() - ref.float()).abs().amax(-1)
        assert (err <= 2e-2 * ref.float().abs().amax(-1)).all(), n
    for bad in (0, 11777):
        length.fill_(bad)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isnan(out.float()).all(), bad
    assert all(int(buf.abs().sum()) == 0 for buf in tda._COUNTERS.values())


@pytest.mark.gpu
def test_cuda_plain_matvec_entry_points_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1024), generator=gen, device=cuda).to(torch.bfloat16)
    w8 = (torch.randn((1024, 768), generator=gen, device=cuda) * 40).clamp(-127, 127).to(torch.int8)
    sc = torch.rand((768,), generator=gen, device=cuda)
    got, ref = tmv.matvec_q8(x, w8, sc), tmv.gemv_stacked_plain(x, [w8[None]], 0)[0] * sc
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    wb = torch.randn((1024, 768), generator=gen, device=cuda).to(torch.bfloat16)
    got, ref = tmv.matvec_bf16(x, wb), tmv.gemv_stacked_plain(x, [wb[None]], 0)[0]
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    with pytest.raises(ValueError, match="multiple of 16"):
        tmv.matvec_q8(x, w8[:, :760].contiguous(), sc[:760])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("rows", [1, 2, 3, 8, 20, 64])
def test_cuda_gemv_edge_shapes_match_plain(cuda, dtype, rows):
    """Kernel C with N off the column tile (784 = 3 x 256 + 16), K = 1003
    off every K-chunk and off the 8-value pieces the rows kernel copies, and
    B = 1, 2, 3, 8, 20 and 64 rows (one, two, three and eight 8-row tiles):
    fp32 sums in another order, 1e-4 of the largest output."""
    gen = torch.Generator(device=cuda).manual_seed(rows)

    def stack(n):
        w = torch.randn((2, 1003, n), generator=gen, device=cuda)
        return (w * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(torch.bfloat16)

    x = torch.randn((rows, 1003), generator=gen, device=cuda).to(torch.bfloat16)
    stacks = [stack(784), stack(16), stack(528)]
    launches = tmv.gemv_stacked.launches
    got = tmv.gemv_stacked(x, stacks, 1)
    assert tmv.gemv_stacked.launches == launches + 1
    for g, ref in zip(got, tmv.gemv_stacked_plain(x, stacks, 1)):
        assert g.shape == ref.shape and (g - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("rows", [1, 8, 20])
def test_cuda_gemv_is_repeatable(cuda, dtype, rows):
    """Kernels C and D: two calls give the same bits, and so do three
    replays of a captured call: the last CTA of each column tile (C) and
    D's epilogue add the K-chunks in chunk order, whichever CTA arrives
    last, and C leaves the arrival counters at zero."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def stack(n):
        w = torch.randn((2, 3584, n), generator=gen, device=cuda)
        return (w * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(torch.bfloat16)

    x = torch.randn((rows, 3584), generator=gen, device=cuda).to(torch.bfloat16)
    stacks = [stack(3584), stack(512), stack(512)]
    sc = torch.rand((2, 3584), generator=gen, device=cuda) if dtype == torch.int8 else None

    def both():
        return [*tmv.gemv_stacked(x, stacks, 1), tmv.gemv_gateup(x, stacks[0], stacks[0], sc, sc, 1)]

    first = both()
    assert all(torch.equal(a, b) for a, b in zip(both(), first))
    # warmed up, then captured, on the capture stream (which then owns its arrival counters)
    held = {}
    graph = capture_graph(lambda: held.update(outs=both()), cuda)
    outs = held["outs"]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))
    torch.cuda.synchronize()
    assert all(int(buf.abs().sum()) == 0 for buf in tda._COUNTERS.values())
