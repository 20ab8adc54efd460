"""PyTorch port vs the JAX package: speculative decoding.

Prompt-lookup drafting (``draft_lookup``), the solo and batched
draft-and-verify loops (``generate_spec``, ``generate_spec_batch``: on the
card replays of one captured macro step, the same step body run eagerly
here), the device forms of ``verify_step`` / ``verify_step_batch`` and
the entry points. The JAX ``CompressionEngine(attn_impl="einsum")`` and the
port's engines (``attn_impl="einsum"``, and ``"flash"``: the kernel
wrappers' plain versions on the CPU) run the same weights (``params_from_numpy``) at
``tests/test_spec_decode.py``'s tiny fp32 geometry (6 layers, bucket 32) on
``tests/test_engine.py``'s prompts. Tolerances:

* on the port's plain path (``attn_impl="einsum"``: fp32, as JAX's) the
  tokens and the stats (macro steps, drafted, accepted) EQUAL JAX's; on
  both paths the tokens equal that engine's own ``generate`` /
  ``generate_batch``;
* a device form against its host-int form: the same arithmetic on the same
  values, bitwise;
* a one-row verify against ``decode_step``: the same masked fp32 softmax
  over other contraction shapes, 1e-5 of the largest logit (JAX's own
  test's bound);
* the ``gpu`` tests: a replayed macro step against its eager body, bitwise;
  kernels C and D at the verify's K and B * K rows within chip_smoke's
  GEMV_RTOL (1e-4 of the largest output) of their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines.qwen2_baselines import BaselineEngine as JaxBaselineEngine
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.spec_decode import draft_lookup as jax_draft_lookup
from framefusion_tpu_torch.baselines import BaselineEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.ops.sampling import SamplerConfig
from framefusion_tpu_torch.runtime import spec_decode
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=6, bucket=32)
ROW_TOL = 1e-5
# tests/test_spec_decode.py's batch: (seed, coherence).
BATCH = [(0, 0.3), (1, 0.45), (2, 0.8)]


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=6)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tiny_llm_config(num_layers=6), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def engines(stacks):
    """JAX's engine and the port's on its plain path ("einsum": fp32, as
    JAX's) and on the kernels' ("flash": the plain versions of C, D and G,
    which round to bf16, so a near-tie of this random model may break
    otherwise than fp32: it is held to its own plain greedy decode)."""
    jcfg, tcfg, jp, tp = stacks
    out = {"jax": JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum")}
    for impl in ("einsum", "flash"):
        out[impl] = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl=impl)
    return out


def _prefill(engine, seed=0, coherent=0.3):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    return engine.prefill(h, pt, pos, 6, start, n_img)


@pytest.fixture(scope="module")
def solo(engines):
    """Each engine's prefill of seeds 0-2, and for the port's its plain
    greedy decode of 24 tokens: {name: {seed: (result, tokens)}}."""
    return {name: {seed: (res, None if name == "jax" else eng.generate(res, 24))
                   for seed in (0, 1, 2) for res in [_prefill(eng, seed)]}
            for name, eng in engines.items()}


# -- drafting ----------------------------------------------------------------------


@pytest.mark.parametrize("draft_len", [1, 4])
def test_draft_lookup_matches_jax(draft_len):
    """~50 seeded histories over a small alphabet (plenty of bigram repeats),
    with hist_len from 0 (nothing to match) up, one at a time and as one
    (B, H) batch: the drafts and the found flag are JAX's."""
    rng = np.random.default_rng(draft_len)
    hists, lens = [], []
    for trial in range(50):
        hl = int(rng.integers(0, 56)) if trial % 10 else int(trial // 10 % 3)  # 0, 1, 2: too short to match
        hist = np.zeros(64, np.int32)
        hist[:hl] = rng.integers(0, 5 if trial % 7 else 40, hl)  # an alphabet of 40: mostly no match
        hists.append(hist)
        lens.append(hl)
        want_d, want_f = jax_draft_lookup(jnp.asarray(hist), jnp.int32(hl), draft_len)
        got_d, got_f = spec_decode.draft_lookup(torch.from_numpy(hist.astype(np.int64)), hl, draft_len)
        assert got_d.tolist() == np.asarray(want_d).tolist() and bool(got_f) == bool(want_f), (trial, hl)
    found = [bool(jax_draft_lookup(jnp.asarray(h), jnp.int32(n), draft_len)[1]) for h, n in zip(hists, lens)]
    assert 5 < sum(found) < 45  # both outcomes drawn
    got_d, got_f = spec_decode.draft_lookup(torch.from_numpy(np.stack(hists).astype(np.int64)), torch.tensor(lens),
                                            draft_len)
    for b, (h, n) in enumerate(zip(hists, lens)):
        want_d, want_f = jax_draft_lookup(jnp.asarray(h), jnp.int32(n), draft_len)
        assert got_d[b].tolist() == np.asarray(want_d).tolist() and bool(got_f[b]) == bool(want_f)


# -- the solo loop ---------------------------------------------------------------------


@pytest.mark.parametrize("draft_len", [1, 4, 7])
@pytest.mark.parametrize("hint", [None, "oracle"])
def test_generate_spec_matches_jax(engines, solo, draft_len, hint):
    """Tokens and stats exactly JAX's on three prompts (the plain path),
    and the tokens each port engine's plain greedy decode.
    ``hint="oracle"`` seeds the history with that decode (near-perfect
    drafts: the prompt_ids path)."""
    for seed in (0, 1, 2):
        plain = solo["einsum"][seed][1]
        pids = np.asarray(plain, np.int32) if hint else None
        want = engines["jax"].generate_spec(solo["jax"][seed][0], 24, draft_len=draft_len, prompt_ids=pids,
                                            return_stats=True)
        got = engines["einsum"].generate_spec(solo["einsum"][seed][0], 24, draft_len=draft_len, prompt_ids=pids,
                                              return_stats=True)
        assert got == want, (seed, got[1], want[1])
        assert got[0] == plain
        if hint:
            assert got[1]["tokens_per_pass"] > 1.5
        res_f, plain_f = solo["flash"][seed]
        assert engines["flash"].generate_spec(res_f, 24, draft_len=draft_len, prompt_ids=pids) == plain_f


def test_generate_spec_eos_and_one_token_match_jax(engines, solo):
    eng_j, eng_t = engines["jax"], engines["einsum"]
    (res_j, _), (res_t, plain) = solo["jax"][0], solo["einsum"][0]
    eos = plain[5]
    got = eng_t.generate_spec(res_t, 24, draft_len=4, eos_token_id=eos)
    assert got == eng_j.generate_spec(res_j, 24, draft_len=4, eos_token_id=eos) == plain[: plain.index(eos) + 1]
    one = eng_t.generate_spec(res_t, 1, draft_len=4, return_stats=True)
    assert one == eng_j.generate_spec(res_j, 1, draft_len=4, return_stats=True) and one[0] == plain[:1]
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng_t.generate_spec(res_t, 0)


# -- the batched loop ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "oracle", "eos"])
def test_generate_spec_batch_matches_jax(engines, case):
    """B = 3: tokens and per-sequence stats exactly JAX's (the plain path),
    the tokens each port engine's plain batched greedy decode (cut after
    eos for "eos")."""
    res = {name: [_prefill(eng, s, c) for s, c in BATCH] for name, eng in engines.items()}
    plain = {impl: engines[impl].generate_batch(res[impl], 20) for impl in ("einsum", "flash")}
    kw = {}
    if case == "oracle":
        kw["prompt_ids"] = [np.asarray(p, np.int32) for p in plain["einsum"][:2]] + [None]
    if case == "eos":
        kw["eos_token_id"] = plain["einsum"][1][4]
    want = engines["jax"].generate_spec_batch(res["jax"], 20, draft_len=4, return_stats=True, **kw)
    got = engines["einsum"].generate_spec_batch(res["einsum"], 20, draft_len=4, return_stats=True, **kw)
    assert got == want, (got[1], want[1])
    eos = kw.get("eos_token_id")
    for impl in ("einsum", "flash"):
        toks = got[0] if impl == "einsum" else engines["flash"].generate_spec_batch(res["flash"], 20, draft_len=4, **kw)
        assert toks == [p[: p.index(eos) + 1] if eos in p else p for p in plain[impl]], impl
    assert len(got[1]["accepted"]) == 3 and got[1]["macro_steps"] <= 19


def test_spec_graphs_are_cached_by_geometry(engines, solo):
    """A second decode of one geometry reuses its graph, as JAX reuses its
    compiled loop; another draft_len makes another."""
    eng_t = engines["flash"]
    res_t = solo["flash"][1][0]
    eng_t.generate_spec(res_t, 24, draft_len=4)
    key = next(k for k in eng_t._graphs if k[0] == "spec" and k[3] == 4)
    graph = eng_t._graphs[key][0]
    eng_t.generate_spec(res_t, 24, draft_len=4)
    assert eng_t._graphs[key] == [graph] and not graph.busy
    eng_t.generate_spec(res_t, 24, draft_len=2)
    assert any(k[0] == "spec" and k[3] == 2 for k in eng_t._graphs)


# -- the verify programs' device forms -----------------------------------------------------


def _pools(rng, *lead, s=64, hk=2, hd=32):
    return tuple(torch.from_numpy((rng.standard_normal((*lead, s, hk, hd)) * 0.5).astype(np.float32))
                 for _ in range(2))


@pytest.fixture(scope="module")
def quantized_params(stacks):
    from framefusion_tpu.ops.quant import quantize_params_int8

    jq8 = quantize_params_int8(jax.tree.map(jnp.copy, stacks[2]))
    return tq.params_from_numpy(jax.device_get(jq8), device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("split", [None, (1, 48)])
def test_verify_step_device_form_is_bitwise_its_host_form(stacks, quantized_params, quantized, impl, split):
    _, tcfg, _, tp = stacks
    params = quantized_params if quantized else tp
    rng = np.random.default_rng(11)
    k_pool, v_pool = _pools(rng, tcfg.num_layers)
    lens = [40, 40, 30, 20, 20, 18]
    rows = torch.from_numpy((rng.standard_normal((5, tcfg.hidden_size)) * 0.05).astype(np.float32))
    pos = list(range(40, 45))
    host = tq.verify_step(params, rows, pos, k_pool.clone(), v_pool.clone(), lens, tcfg, attn_impl=impl,
                          tail_split=split)
    dev = tq.verify_step(params, rows, torch.tensor(pos), k_pool.clone(), v_pool.clone(), torch.tensor(lens), tcfg,
                         attn_impl=impl, tail_split=split, gate=torch.tensor(True))
    for a, b in zip(host, dev):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", [None, (1, 32, 40), "phys"])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_verify_step_batch_device_form_is_bitwise_its_host_form(stacks, layout, impl):
    """A device ``step`` (and a device ``write_pos``, the serving chunk's
    cursor) against host ints: the same logits and pools, bit for bit,
    also in the physically split layout."""
    _, tcfg, _, tp = stacks
    rng = np.random.default_rng(12)
    k_pool, v_pool = _pools(rng, tcfg.num_layers, 3)
    lens = [[30, 25, 20]] * 2 + [[20, 18, 10]] * 4
    embs = torch.from_numpy((rng.standard_normal((3, 4, tcfg.hidden_size)) * 0.05).astype(np.float32))
    pos = torch.tensor([[30 + i for i in range(4)], [25 + i for i in range(4)], [20 + i for i in range(4)]])
    mask = torch.zeros((3, 64), dtype=torch.bool)
    mask[:, 40:42] = True
    kw = dict(tail_split=layout)
    if layout == "phys":
        k_tail = torch.cat([k_pool[1:, :, :32], k_pool[1:, :, 40:]], dim=2)
        v_tail = torch.cat([v_pool[1:, :, :32], v_pool[1:, :, 40:]], dim=2)
        k_pool, v_pool = k_pool[:1], v_pool[:1]
        kw = dict(phys=(1, 32, 40))
    outs = []
    for write_pos, step in ((40, 1), (40, torch.tensor(1)), (torch.tensor(40), torch.tensor(1))):
        if layout == "phys":
            kw.update(k_tail=k_tail.clone(), v_tail=v_tail.clone())
        outs.append(tq.verify_step_batch(tp, embs, pos, k_pool.clone(), v_pool.clone(), lens, mask, write_pos, step,
                                         tcfg, attn_impl=impl, **kw))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert (a is None and b is None) or torch.equal(a, b)


def test_gated_verify_writes_nothing_and_stays_in_bounds(stacks):
    """A closed gate leaves the pools as they were, bit for bit, even where
    the K rows would run past the pool's end (an index_copy_ past the end
    raises on the CPU)."""
    _, tcfg, _, tp = stacks
    rng = np.random.default_rng(13)
    k_pool, v_pool = _pools(rng, tcfg.num_layers)
    rows = torch.from_numpy((rng.standard_normal((5, tcfg.hidden_size)) * 0.05).astype(np.float32))
    kp, vp = k_pool.clone(), v_pool.clone()
    tq.verify_step(tp, rows, torch.arange(62, 67), kp, vp, torch.full((tcfg.num_layers,), 62), tcfg,
                   gate=torch.tensor(False))
    assert torch.equal(kp, k_pool) and torch.equal(vp, v_pool)
    kb, vb = _pools(rng, tcfg.num_layers, 2)
    kb2, vb2 = kb.clone(), vb.clone()
    tq.verify_step_batch(tp, rows[None, :4].expand(2, -1, -1), torch.arange(60, 64).expand(2, -1), kb2, vb2,
                         [[20, 20]] * tcfg.num_layers, torch.zeros((2, 64), dtype=torch.bool), torch.tensor(40),
                         torch.tensor(6), tcfg, gate=torch.tensor(False))
    assert torch.equal(kb2, kb) and torch.equal(vb2, vb)
    with pytest.raises(ValueError, match="gate"):
        tq.verify_step(tp, rows, list(range(5)), kp, vp, [0] * tcfg.num_layers, tcfg, gate=torch.tensor(True))


def test_one_row_verify_equals_decode_step(stacks):
    """K = 1 is one decode step: the same masked fp32 softmax (ROW_TOL)."""
    _, tcfg, _, tp = stacks
    rng = np.random.default_rng(14)
    k_pool, v_pool = _pools(rng, tcfg.num_layers)
    lens = [40, 40, 30, 20, 20, 18]
    emb = torch.from_numpy((rng.standard_normal(tcfg.hidden_size) * 0.05).astype(np.float32))
    for impl in ("einsum", "flash"):
        lg_d, kd, vd, _ = tq.decode_step(tp, emb, 40, k_pool.clone(), v_pool.clone(), lens, tcfg, attn_impl=impl)
        lg_v, kv, vv = tq.verify_step(tp, emb[None], [40], k_pool.clone(), v_pool.clone(), lens, tcfg, attn_impl=impl)
        scale = float(lg_d.abs().max())
        assert float((lg_v[0] - lg_d).abs().max()) <= ROW_TOL * scale, impl
        assert float((kv - kd).abs().max()) <= ROW_TOL and float((vv - vd).abs().max()) <= ROW_TOL


@pytest.mark.parametrize("batched", [False, True])
def test_gated_macro_steps_after_the_end_change_nothing(engines, solo, batched):
    """Replays past the end (the eager body here): every buffer of the
    graph, pools and stats included, stays bit for bit as it was, and no
    write falls outside a buffer."""
    eng_t = engines["flash"]
    if batched:
        res = [solo["flash"][s][0] for s in (0, 1)]
        hist_cap = spec_decode.history_cap([0, 0], 12, 4)
        graph = eng_t.spec_batch_graph(res, 12, 4, hist_cap)
        cols = [eng_t.make_decode_state(r, 0, pools=(graph.k_pool, graph.v_pool), column=b)[2]
                for b, r in enumerate(res)]
        graph.start(list(zip(*cols)), [r.decode_pos_base for r in res], torch.stack([r.logits for r in res]),
                    [[], []], 12)
        spec_decode.spec_decode_loop_batch(graph, 12)
    else:
        res = solo["flash"][0][0]
        graph = eng_t.spec_graph(res, 12, 4, spec_decode.history_cap([0], 12, 4))
        _, _, lens = eng_t.make_decode_state(res, 0, pools=(graph.k_pool, graph.v_pool))
        graph.start(lens, res.decode_pos_base, res.logits, [[]], 12)
        spec_decode.spec_decode_loop(graph, 12)
    names = [n for n, v in vars(graph).items() if isinstance(v, torch.Tensor)]
    before = {n: getattr(graph, n).clone() for n in names}
    assert int(graph.emitted.min()) >= 12
    graph.run(6)
    for n in names:
        assert torch.equal(getattr(graph, n), before[n]), n


# -- the entry points -------------------------------------------------------------------------


def _inputs(cls, seed, coherent=0.4):
    h, pt, pos, start, n_img = build_inputs(seed=seed, coherent=coherent)
    return cls(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
               image_token_length=n_img)


def test_model_generate_speculative_matches_jax(stacks):
    """``FrameFusionModel.generate(speculative=True)`` and
    ``generate_batch(speculative=True)``: JAX's tokens, the plain ones; a
    sampler with speculation raises (JAX asserts)."""
    jcfg, tcfg, jp, tp = stacks
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.4, 0.75, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.4, 0.75, 0.05)
    for m in (jm, tm):
        m.ff = m.ff.replace(schedule_num_layers=6, bucket=32)
    got, _ = tm.generate(_inputs(PrefillInputs, 0), max_new_tokens=12, speculative=True, draft_len=3)
    assert got == jm.generate(_inputs(JaxInputs, 0), max_new_tokens=12, speculative=True, draft_len=3)[0]
    assert got == tm.generate(_inputs(PrefillInputs, 0), max_new_tokens=12)[0]
    pids = [np.asarray(got, np.int32), None]
    got_b, _ = tm.generate_batch([_inputs(PrefillInputs, s) for s in (0, 1)], max_new_tokens=12, speculative=True,
                                 prompt_ids=pids)
    assert got_b == jm.generate_batch([_inputs(JaxInputs, s) for s in (0, 1)], max_new_tokens=12, speculative=True,
                                      prompt_ids=pids)[0]
    assert got_b == tm.generate_batch([_inputs(PrefillInputs, s) for s in (0, 1)], max_new_tokens=12)[0]
    with pytest.raises(ValueError, match="greedy"):
        tm.generate(_inputs(PrefillInputs, 0), max_new_tokens=4, speculative=True, sampler=SamplerConfig(0.7))


def test_sink_cache_baseline_refuses_speculation_like_jax(stacks):
    jcfg, tcfg, jp, tp = stacks
    kwargs = {"length_rate": 0.4, "sink_cache_decode": True}
    eng_j = JaxBaselineEngine(jp, jcfg, "streamingllm", kwargs, attn_impl="einsum", bucket=32)
    eng_t = BaselineEngine(tp, tcfg, "streamingllm", kwargs, bucket=32)
    res_j, res_t = _prefill(eng_j), _prefill(eng_t)
    for eng, res in ((eng_j, res_j), (eng_t, res_t)):
        with pytest.raises(NotImplementedError):
            eng.generate_spec(res, 8)
        with pytest.raises(NotImplementedError):
            eng.generate_spec_batch([res], 8)
    plain = BaselineEngine(tp, tcfg, "streamingllm", {"length_rate": 0.4}, bucket=32)
    res = _prefill(plain)
    assert plain.generate_spec(res, 8, draft_len=3) == plain.generate(res, 8)


# -- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_model(cuda):
    cfg = tiny_llm_config(num_layers=6, hidden_size=512, intermediate_size=1024, num_heads=4, num_kv_heads=2,
                          dtype=torch.bfloat16)
    params = tq.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = CompressionEngine(params, cfg, FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6,
                                                           ratio_lower_bound=0.1, schedule_num_layers=6, bucket=32))
    return cfg, eng


def _card_prompts(cfg, cuda, n):
    from framefusion_tpu_torch.models.adapters.common import build_video_prompt

    out = []
    for seed in range(n):
        h, pt, start, n_img = build_video_prompt(np.random.default_rng(seed), cfg.hidden_size, n_frames=12,
                                                 patch_num=8, n_pre=6, n_post=5, coherent=0.4)
        out.append((torch.from_numpy(h).to(cuda, torch.bfloat16), pt, np.arange(len(pt)), 8, start, n_img))
    return out


def _replay_equals_eager(graph, n: int) -> None:
    """``n`` replays against the eager body run on the capture stream from
    the same state: every buffer bitwise equal."""
    from framefusion_tpu_torch.runtime.decode_graph import capture_stream

    names = [k for k, v in vars(graph).items() if isinstance(v, torch.Tensor) and k != "counters"]
    start = {k: getattr(graph, k).clone() for k in names}
    graph.run(n)
    torch.cuda.synchronize()
    replayed = {k: getattr(graph, k).clone() for k in names}
    for k in names:
        getattr(graph, k).copy_(start[k])
    with torch.cuda.stream(capture_stream(graph.k_pool.device)):
        for _ in range(n):
            graph._step()
    torch.cuda.synchronize()
    for k in names:
        assert torch.equal(getattr(graph, k), replayed[k]), k


@pytest.mark.gpu
def test_cuda_spec_graphs_equal_their_eager_bodies(cuda):
    """The solo and batched macro steps captured (kernels C and D at K and
    B * K rows inside) against the same bodies run eagerly: bitwise; the
    graphs' tokens are the plain greedy decodes' (within bf16 ties: the
    agreement is the engine's own graph decode, same kernels and rows)."""
    from framefusion_tpu_torch.runtime.decode_graph import DecodeGraph

    cfg, eng = _card_model(cuda)
    res = [eng.prefill(*p) for p in _card_prompts(cfg, cuda, 3)]
    replays = DecodeGraph.replays
    toks, stats = eng.generate_spec(res[0], 16, draft_len=4, return_stats=True)
    assert DecodeGraph.replays - replays == stats["macro_steps"]
    graph = eng.spec_graph(res[0], 16, 4, spec_decode.history_cap([0], 16, 4))
    assert graph.launches_per_step == {"gemv_stacked": 3 * cfg.num_layers, "gemv_gateup": cfg.num_layers}
    _, _, lens = eng.make_decode_state(res[0], 0, pools=(graph.k_pool, graph.v_pool))
    graph.start(lens, res[0].decode_pos_base, res[0].logits, [[]], 16)
    _replay_equals_eager(graph, 3)
    out = eng.generate_spec_batch(res, 16, draft_len=4)
    bgraph = eng.spec_batch_graph(res, 16, 4, spec_decode.history_cap([0] * 3, 16, 4))
    cols = [eng.make_decode_state(r, 0, pools=(bgraph.k_pool, bgraph.v_pool), column=b)[2] for b, r in enumerate(res)]
    bgraph.start(list(zip(*cols)), [r.decode_pos_base for r in res], torch.stack([r.logits for r in res]),
                 [[]] * 3, 16)
    _replay_equals_eager(bgraph, 3)
    assert len(out) == 3 and all(len(row) == 16 for row in out) and len(toks) == 16


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [5, 20])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cuda_gemv_at_verify_rows_matches_plain(cuda, rows, dtype):
    """Kernels C and D at the verify's K = 5 and B * K = 20 rows, at
    Qwen2-7B's q/k/v and gate-up widths (2 layers), within 1e-4 of the
    largest output of their plain versions."""
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
    from framefusion_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, 3584), generator=gen, device=cuda).to(torch.bfloat16)
    stacks, scales = [], []
    for n in (3584, 512, 512, 18944, 18944):
        w = (torch.randn((2, 3584, n), generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
        s = None
        if dtype == "int8":
            wq = quantize_weight(w)
            w, s = wq["q8"], wq["scale"]
        stacks.append(w)
        scales.append(s)
    qkv, (wg, wu), (sg, su) = stacks[:3], stacks[3:], scales[3:]
    outs = list(tmv.gemv_stacked(x, qkv, 1)) + [tmv.gemv_gateup(x, wg, wu, sg, su, 1)]
    refs = list(tmv.gemv_stacked_plain(x, qkv, 1)) + [tmv.gemv_gateup_plain(x, wg, wu, sg, su, 1)]
    for got, ref in zip(outs, refs):
        assert got.shape == ref.shape and got.shape[0] == rows
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
