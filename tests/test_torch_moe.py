"""PyTorch port vs the JAX package: the Qwen2-MoE sparse block.

One set of block weights (``framefusion_tpu.models.moe.init_moe_params``,
fetched as numpy and carried over with ``qwen2.params_from_numpy``) and numpy
inputs go through JAX's ``sparse_mlp`` and the port's. The port routes with
JAX's GShard capacity decisions but moves the tokens by index, not by
one-hot products, so the kept (token, expert) set must be EQUAL and the
values agree to 1e-5 relative in fp32 (the combine adds k terms in another
order). The kept set is read out of each side's own output with probe
expert weights: expert e writes only to its own block of output columns
and the shared expert is zero, so a token's block e is non-zero exactly
when its choice of e kept its slot.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import tiny_moe_llm_config as jax_tiny_moe
from framefusion_tpu.models import moe as jmoe
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.ops.quant import quantize_params_int8 as jax_quantize
from framefusion_tpu_torch.config import tiny_moe_llm_config
from framefusion_tpu_torch.models import moe as tmoe
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv

# Tiny shapes: one intra-op thread each (pytest-xdist workers share the cores).
torch.set_num_threads(1)

TOL = 1e-5  # fp32, relative to the largest output
BF16_TOL = 2e-3  # the kernels' plain versions round rows and weights to bf16
S = 24


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def block():
    cfg = jmoe.tiny_moe_config(num_experts=4, top_k=2)
    jp = jax.jit(jmoe.init_moe_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((S, cfg.hidden_size)).astype(np.float32) * 0.5
    tp = tq.params_from_numpy(jax.device_get(jp), device="cpu")
    return cfg, jp, tp, x


@functools.partial(jax.jit, static_argnames=("num_experts", "top_k", "norm_topk_prob", "capacity"))
def _jax_sparse_jit(jp, x, live, **kw):
    return jmoe.sparse_mlp(jp, x, live=live, **kw)


def _jax_sparse(jp, x, cfg, capacity=None, live=None):
    y, probs = _jax_sparse_jit(jp, jnp.asarray(x), None if live is None else jnp.asarray(live),
                               num_experts=cfg.num_experts, top_k=cfg.top_k, norm_topk_prob=cfg.norm_topk_prob,
                               capacity=capacity)
    return np.asarray(y), np.asarray(probs)


def _torch_sparse(tp, x, cfg, capacity=None, live=None):
    y, probs = tmoe.sparse_mlp(tp, torch.from_numpy(x), num_experts=cfg.num_experts, top_k=cfg.top_k,
                               norm_topk_prob=cfg.norm_topk_prob, capacity=capacity,
                               live=None if live is None else torch.from_numpy(live))
    return _np(y), _np(probs)


def _probe(params: dict, cfg, seed: int = 1) -> dict:
    """The block's router with probe experts: expert e's down projection
    writes only columns [e * D / E, (e + 1) * D / E), the shared expert is zero."""
    rng = np.random.default_rng(seed)
    d, i, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    w_down = np.zeros((e, i, d), np.float32)
    w = d // e
    for j in range(e):
        w_down[j, :, j * w:(j + 1) * w] = rng.standard_normal((i, w))
    probe = {k: np.array(v, np.float32) for k, v in params.items()}
    probe.update(w_gate=rng.standard_normal((e, d, i)).astype(np.float32),
                 w_up=rng.standard_normal((e, d, i)).astype(np.float32), w_down=w_down,
                 sw_down=np.zeros_like(probe["sw_down"]))
    return probe


def _kept(y: np.ndarray, cfg) -> set:
    """(token, expert) pairs whose expert block of the probe output is non-zero."""
    w = cfg.hidden_size // cfg.num_experts
    return {(t, e) for t in range(y.shape[0]) for e in range(cfg.num_experts)
            if np.abs(y[t, e * w:(e + 1) * w]).max() > 0}


@pytest.mark.parametrize("capacity", [None, 8, 3], ids=["lossless", "tight", "tighter"])
def test_sparse_mlp_matches_jax(block, capacity):
    """Values within 1e-5 of JAX's, and the kept (token, expert) set equal to
    JAX's, at lossless and tight capacity (S 24, k 2, E 4: 12 a balanced
    expert; C 8 and 3 drop)."""
    cfg, jp, tp, x = block
    y_j, probs_j = _jax_sparse(jp, x, cfg, capacity)
    y_t, probs_t = _torch_sparse(tp, x, cfg, capacity)
    _close(y_t, y_j, TOL)
    _close(probs_t, probs_j, TOL)

    probe = _probe(jax.device_get(jp), cfg)
    kept_j = _kept(_jax_sparse({k: jnp.asarray(v) for k, v in probe.items()}, x, cfg, capacity)[0], cfg)
    tprobe = {k: torch.from_numpy(v) for k, v in probe.items()}
    kept_t = _kept(_torch_sparse(tprobe, x, cfg, capacity)[0], cfg)
    _, slot, keep, c, _ = tmoe.route(torch.from_numpy(x), tprobe["router"], num_experts=cfg.num_experts,
                                     top_k=cfg.top_k, norm_topk_prob=False, capacity=capacity)
    from_route = {(t, int(slot[t, r]) // c) for t in range(S) for r in range(cfg.top_k) if keep[t, r]}
    assert kept_t == kept_j == from_route
    assert len(kept_j) == (S * cfg.top_k if capacity is None else len(kept_j))
    if capacity is not None:
        assert len(kept_j) < S * cfg.top_k  # the tight cases drop
        with tmoe.record_drops() as drops:
            _torch_sparse(tp, x, cfg, capacity)
        assert [(s, c_, int(d)) for s, c_, d in drops] == [(S, capacity, S * cfg.top_k - len(kept_j))]


@pytest.mark.parametrize("rule", ["rank_major", "live_mask"])
def test_routing_rules_match_jax(block, rule):
    """rank_major: at a capacity equal to an expert's rank-1 users, a later
    token's rank-1 claim beats an earlier token's rank-2 claim, on both
    sides. live_mask: rows outside ``live`` claim no slot, so the live rows
    route as the same rows compacted to the front of a smaller buffer do (at
    the capacity of each buffer's physical rows, as the engines call it),
    and the port equals JAX either way."""
    cfg, jp, tp, x = block
    probe = _probe(jax.device_get(jp), cfg)
    jprobe = {k: jnp.asarray(v) for k, v in probe.items()}
    tprobe = {k: torch.from_numpy(v) for k, v in probe.items()}
    if rule == "rank_major":
        _, idx, _ = jmoe.router_probs(jprobe, jnp.asarray(x), cfg)
        idx = np.asarray(idx)
        pairs = [(e, int(np.where(idx[:, 1] == e)[0][0]), int(np.where(idx[:, 0] == e)[0][-1]))
                 for e in range(cfg.num_experts)
                 if (idx[:, 0] == e).any() and (idx[:, 1] == e).any()
                 and np.where(idx[:, 1] == e)[0][0] < np.where(idx[:, 0] == e)[0][-1]]
        assert pairs, "this seed's routing has a rank inversion"
        e, t2, t1 = pairs[0]
        c = int((idx[:, 0] == e).sum())
        kept_j = _kept(_jax_sparse(jprobe, x, cfg, c)[0], cfg)
        kept_t = _kept(_torch_sparse(tprobe, x, cfg, c)[0], cfg)
        assert kept_t == kept_j
        assert (t1, e) in kept_t and (t2, e) not in kept_t
        return
    live = np.zeros(S, bool)
    live[[0, 2, 3, 5, 8, 9, 10, 13, 14, 17, 19, 20, 22]] = True
    n = int(live.sum())
    c_full = 6  # the capacity the S-row call is given
    y_j, _ = _jax_sparse(jp, x, cfg, c_full, live)
    y_t, _ = _torch_sparse(tp, x, cfg, c_full, live)
    _close(y_t, y_j, TOL)
    kept_live = _kept(_torch_sparse(tprobe, x, cfg, c_full, live)[0], cfg)
    assert kept_live == _kept(_jax_sparse(jprobe, x, cfg, c_full, live)[0], cfg)
    assert {t for t, _ in kept_live} <= set(np.where(live)[0])
    compact = x[live]
    kept_compact = _kept(_torch_sparse(tprobe, compact, cfg, c_full)[0], cfg)
    rows = np.where(live)[0]
    assert {(int(rows[t]), e) for t, e in kept_compact} == kept_live
    _close(_torch_sparse(tp, compact, cfg, c_full)[0], y_t[live], TOL)


def test_moe_layer_matches_jax(block):
    """``moe_layer`` (the attention block, then ``moe_mlp`` at lossless
    capacity) against JAX's on the same weights and rows, to 1e-5; and
    ``init_moe_params`` draws JAX's layout."""
    from framefusion_tpu.config import tiny_llm_config as jax_tiny
    from framefusion_tpu_torch.config import tiny_llm_config

    cfg, jp, tp, x = block
    layout = tmoe.init_moe_params(tmoe.tiny_moe_config(), torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in layout.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    jcfg = jax_tiny(num_layers=1, hidden_size=cfg.hidden_size, num_heads=4, num_kv_heads=2)
    tcfg = tiny_llm_config(num_layers=1, hidden_size=cfg.hidden_size, num_heads=4, num_kv_heads=2)
    jlp = jq.layer_slice(jq.init_params(jcfg, jax.random.PRNGKey(1))["layers"], 0)
    tlp = tq.params_from_numpy(jax.device_get(jlp), device="cpu")
    h = x * np.float32(0.1)
    pos = np.arange(S)
    jcos, jsin = jq.positions_cos_sin(jnp.asarray(pos, jnp.int32), jcfg)
    tcos, tsin = tq.positions_cos_sin(torch.from_numpy(pos), tcfg)
    want, probs_j = jax.jit(jmoe.moe_layer, static_argnums=(5, 6))(jlp, jp, jnp.asarray(h), jcos, jsin, jcfg, cfg)
    tcfg_moe = tmoe.MoeConfig(**{f: getattr(cfg, f) for f in ("hidden_size", "moe_intermediate_size",
                                                             "shared_expert_intermediate_size", "num_experts",
                                                             "top_k", "norm_topk_prob")})
    got, probs_t = tmoe.moe_layer(tlp, tp, torch.from_numpy(h), tcos, tsin, tcfg, tcfg_moe)
    _close(got, np.asarray(want), TOL)
    _close(probs_t, np.asarray(probs_j), TOL)


@pytest.fixture(scope="module")
def stack():
    jcfg = jax_tiny_moe(num_layers=2)
    tcfg = tiny_moe_llm_config(num_layers=2)
    jp = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_moe_decode_mlp_rows_match_jax(stack, weights):
    """R = 5 decode rows: the port's plain ``moe_decode_mlp`` against JAX's
    vmapped one (1e-5), and the port's routed-kernel path (kernels C and D
    with a stack index a row; their plain versions here) within the bf16
    bound of the plain path."""
    jcfg, tcfg, jp, tp = stack
    if weights == "int8":
        jp = jax_quantize(jax.tree.map(jnp.copy, jp))
        tp = tq.params_from_numpy(jax.device_get(jp), device="cpu")
        assert tp["layers"]["w_gate"]["q8"].ndim == 4 and not isinstance(tp["layers"]["router"], dict)
    h = np.random.default_rng(4).standard_normal((5, tcfg.hidden_size)).astype(np.float32)
    l = 1
    want = jax.jit(jax.vmap(lambda lp, row: jq.moe_decode_mlp(lp, row, jcfg), in_axes=(None, 0)))(
        jq.layer_slice(jp["layers"], l), jnp.asarray(h))
    lp = tq.layer_slice(tp["layers"], l)
    plain = tq.moe_decode_mlp(lp, torch.from_numpy(h), tcfg)
    _close(plain, want, TOL)
    routed = tq.moe_decode_mlp(lp, torch.from_numpy(h), tcfg, tp["layers"], l)
    _close(routed, plain, BF16_TOL)


@pytest.mark.parametrize("wdtype", ["bf16", "int8"])
def test_routed_plain_versions_match_gathered_products(wdtype):
    """Kernels C and D with a stack index a row (plain versions): row r times
    ``w.view(L * E, K, N)[idx[r]]``, as the gathered weights' products, in
    one call and over more than ``MAX_ROWS`` rows (several launches on the
    card)."""
    g = torch.Generator().manual_seed(5)
    n_l, e, k, n = 3, 4, 32, 48
    rows = tmv.MAX_ROWS + 8
    x = torch.randn((rows, k), generator=g).to(torch.bfloat16)
    idx = torch.randint(0, n_l * e, (rows,), generator=g, dtype=torch.int32)
    ws = [torch.randn((n_l, e, k, n), generator=g) for _ in range(3)]
    scales = [None, None]
    if wdtype == "int8":
        ws = [torch.randint(-127, 128, w.shape, generator=g, dtype=torch.int8) for w in ws]
        scales = [torch.rand((n_l, e, n), generator=g) * 0.01 for _ in range(2)]
    else:
        ws = [w.to(torch.bfloat16) for w in ws]
    xf = x.to(torch.float32)

    def gathered(w):
        return torch.einsum("rk,rkn->rn", xf, w.reshape(-1, k, n)[idx.long()].to(torch.float32))

    got = tmv.matvec_routed(x, ws[2], idx)
    assert torch.allclose(got, gathered(ws[2]), rtol=1e-5, atol=1e-3)
    first = tmv.gemv_stacked(x[:8], [ws[2].reshape(-1, k, n)], 0, idx[:8])[0]
    assert torch.equal(first, got[:8])
    gu = tmv.matvec_routed_gateup(x, ws[0], ws[1], scales[0], scales[1], idx)
    gate, up = gathered(ws[0]), gathered(ws[1])
    if wdtype == "int8":
        gate = gate * scales[0].reshape(-1, n)[idx.long()]
        up = up * scales[1].reshape(-1, n)[idx.long()]
    assert torch.allclose(gu, torch.nn.functional.silu(gate) * up, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="index must be"):
        tmv.gemv_stacked(x[:4], [ws[2].reshape(-1, k, n)], 0, idx[:4].long())


@pytest.fixture(scope="module")
def bf16_router():
    """The bf16 scenario of the tie-break fault: x (2048, 512) standard
    normal, the router (512, 64) / sqrt(512), both bf16 (numpy seed 0); its
    logits are rounded to bf16 before the fp32 softmax, so equal
    probabilities are common."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2048, 512)).astype(np.float32)
    router = (rng.standard_normal((512, 64)) / np.sqrt(512)).astype(np.float32)
    cfg = jmoe.MoeConfig(hidden_size=512, moe_intermediate_size=8, shared_expert_intermediate_size=8,
                         num_experts=64, top_k=8, norm_topk_prob=False, dtype=jnp.bfloat16)
    jx, jr = jnp.asarray(x, jnp.bfloat16), jnp.asarray(router, jnp.bfloat16)
    tx, tr = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(router).to(torch.bfloat16)
    return cfg, jx, jr, tx, tr


def test_bf16_router_ties_break_like_jax(bf16_router):
    """At bf16 logits the port's top-k equals JAX's ``router_probs`` on all
    2,048 rows, in set and in order (the rank-major capacity priority reads
    the order): at a tie the lower expert ranks first, as ``lax.top_k``
    ranks it (``torch.topk`` ordered 228 rows otherwise, 47 of them with
    another set). The weights are the probabilities at those indices."""
    cfg, jx, jr, tx, tr = bf16_router
    w_j, idx_j, probs_j = jmoe.router_probs({"router": jr}, jx, cfg)
    w_t, idx_t, probs_t = tmoe.top_k_experts(tx, tr, cfg.top_k, cfg.norm_topk_prob)
    top = -np.sort(-_np(probs_t), -1)[:, :cfg.top_k + 1]
    assert int((top[:, 1:] == top[:, :-1]).any(-1).sum()) > 100  # ties inside or at the edge of the top 8
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert not np.array_equal(torch.topk(probs_t, cfg.top_k).indices.numpy(), np.asarray(idx_j))
    # The bf16 logits differ by at most one ulp (2^-7 at |logit| < 2) where
    # the two products sum in another order: probabilities within 1.6e-2.
    for got, want in ((probs_t, probs_j), (w_t, w_j)):
        want = np.asarray(want, np.float32)
        assert (np.abs(_np(got) - want) / want).max() <= 1.6e-2


def test_bf16_capacity_drops_match_jax(bf16_router):
    """``route`` at factor 1.25 (C 320) drops the same (token, rank)
    choices as JAX's ``sparse_mlp``. JAX's keep rule (``sparse_mlp``'s
    one-hot of ``lax.top_k``'s indices, live-masked, rank-major cumulative
    sum, ``pos < C``) runs here on its own op sequence; its (S, k, E, C)
    dispatch tensor (670 MB at this size) is not built."""
    cfg, jx, jr, tx, tr = bf16_router
    s, k, e = jx.shape[0], cfg.top_k, cfg.num_experts
    c = math.ceil(s * k / e * 1.25)
    assert c == 320
    _, idx_j, _ = jmoe.router_probs({"router": jr}, jx, cfg)
    oh = jax.nn.one_hot(idx_j, e, dtype=jnp.int32)
    pos = (jnp.cumsum(oh.transpose(1, 0, 2).reshape(k * s, e), axis=0) - 1).reshape(k, s, e).transpose(1, 0, 2)
    keep_j = np.asarray(jnp.any((pos < c) & (oh > 0), axis=-1))  # (S, k)
    with tmoe.record_drops() as drops:
        _, _, keep_t, c_t, _ = tmoe.route(tx, tr, num_experts=e, top_k=k, norm_topk_prob=False, capacity=c)
    dropped_j = set(zip(*np.where(~keep_j)))
    assert c_t == c and dropped_j  # factor 1.25 drops choices here
    assert set(zip(*np.where(~keep_t.numpy()))) == dropped_j
    assert [(n, cap, int(d)) for n, cap, d in drops] == [(s, c, len(dropped_j))]


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_cuda_routed_rows_match_plain_and_repeat(cuda, dtype):
    """Kernels C and D with a device stack index a row against their plain
    versions (1e-4 of the largest output: fp32 sums in another order), over
    more than 64 rows (two launches); each replay of a captured routed call
    gives the eager call's output bit for bit."""
    from framefusion_tpu_torch.runtime.decode_graph import capture_graph

    gen = torch.Generator(device=cuda).manual_seed(7)
    n_l, e, k, n = 2, 8, 1003, 784
    rows = tmv.MAX_ROWS + 8

    def stack(*shape):
        w = torch.randn(shape, generator=gen, device=cuda)
        return (w * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(torch.bfloat16)

    wg, wu, wd = stack(n_l, e, k, n), stack(n_l, e, k, n), stack(n_l, e, n, k + 5)
    sg = su = None
    if dtype == torch.int8:
        sg, su = (torch.rand((n_l, e, n), generator=gen, device=cuda) * 0.01 for _ in range(2))
    x = torch.randn((rows, k), generator=gen, device=cuda).to(torch.bfloat16)
    idx = torch.randint(0, n_l * e, (rows,), generator=gen, device=cuda, dtype=torch.int32)
    launches = (tmv.gemv_stacked.launches, tmv.gemv_gateup.launches)
    gu = tmv.matvec_routed_gateup(x, wg, wu, sg, su, idx)
    down = tmv.matvec_routed(gu.to(torch.bfloat16), wd, idx)
    assert (tmv.gemv_stacked.launches - launches[0], tmv.gemv_gateup.launches - launches[1]) == (2, 2)
    ref_gu = torch.cat([tmv.gemv_gateup_plain(x[i:i + 64], wg.flatten(0, 1), wu.flatten(0, 1),
                                              None if sg is None else sg.flatten(0, 1),
                                              None if su is None else su.flatten(0, 1), 0, idx[i:i + 64])
                        for i in (0, 64)])
    ref_down = tmv.gemv_stacked_plain(gu.to(torch.bfloat16), [wd.flatten(0, 1)], 0, idx)[0]
    for got, ref in ((gu, ref_gu), (down, ref_down)):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    eager = tmv.matvec_routed(x[:16], wg, idx[:16])
    held = {}
    graph = capture_graph(lambda: held.update(out=tmv.matvec_routed(x[:16], wg, idx[:16])), cuda)
    for _ in range(3):  # capturing computes nothing: each replay writes the output
        held["out"].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(held["out"], eager)
