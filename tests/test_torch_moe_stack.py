"""PyTorch port vs the JAX package: the Qwen2-MoE backbone end to end.

The compression executors, the decode entry points and the loader on MoE
layer stacks (``tiny_moe_llm_config``: 4 experts, top-2, a shared expert).
The JAX ``CompressionEngine(attn_impl="einsum", compact_pre_event=True)``
and the port's engine run the same weights (``params_from_numpy``) and the
same ``tests/test_engine.build_inputs`` prompts in fp32.

Each executor computes its expert capacity from the rows it physically
holds at each MLP call, as its JAX counterpart does (the fused executor
compacts after the layer -1 merge, which JAX's does with
``compact_pre_event=True``; the planned one at its buckets; the segmented
one at each event's bucket; the tails at the compacted bucket with the pad
rows kept out of the routing). So at the tight capacity factor 1.25, where
experts overflow, the drops of every MLP call must be EQUAL to JAX's: the
JAX side's are counted by JAX's own routing arithmetic inside its traced
programs (a debug callback), the port's by ``models.moe.record_drops``.
Events, valid lengths, per-layer cache lengths and greedy tokens are equal;
logits agree to 1e-4 (fp32, summed in other orders through six layers).
"""

import os

# transformers loads TensorFlow and Flax when it finds them, which doubles
# its import time; these tests use its PyTorch models only.
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_moe_llm_config as jax_tiny_moe
from framefusion_tpu.models import moe as jmoe
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.ops.quant import quantize_params_int8 as jax_quantize
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu_torch.baselines import BaselineEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_moe_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import moe as tmoe
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
from framefusion_tpu_torch.ops.quant import QUANTIZED_LAYER_WEIGHTS, quantize_params_int8
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.runtime.serving import ServeRequest
from framefusion_tpu_torch.weights import llm_config_from_hf, load_checkpoint
from test_engine import build_inputs

# Tiny shapes: one intra-op thread each (pytest-xdist workers share the cores).
torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 2e-3  # the kernels' plain versions round rows and weights to bf16
# Logits after six layers and the head, every matvec on rows rounded to bf16,
# against JAX's fp32 path, of the largest logit (2.7e-3 measured on the CPU).
STACK_BF16_TOL = 1e-2
FF = dict(cost=0.5, similarity_lower_bound=0.8, ratio_lower_bound=0.05, schedule_num_layers=6, bucket=32)


@pytest.fixture(scope="module")
def weights():
    """One set of weights for every capacity factor (the factor only sets
    the prefill's capacity)."""
    jp = jax.jit(jq.init_params, static_argnums=0)(jax_tiny_moe(num_layers=6), jax.random.PRNGKey(0))
    return jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


def _stacks(weights, factor):
    return (jax_tiny_moe(num_layers=6, moe_capacity_factor=factor),
            tiny_moe_llm_config(num_layers=6, moe_capacity_factor=factor)) + weights


@pytest.fixture(scope="module", params=[4.0, 1.25], ids=["lossless", "tight"])
def stacks(request, weights):
    return _stacks(weights, request.param)


@pytest.fixture(scope="module")
def tight(weights):
    """The run's capacity factor, 1.25, where this stack's experts overflow."""
    return _stacks(weights, 1.25)


@pytest.fixture(scope="module", autouse=True)
def jax_drops():
    """For this module, JAX's ``sparse_mlp`` counts each call's dropped
    (token, rank) choices with JAX's own routing lines inside the traced
    program, into the list it yields (a test clears it before its run); the
    programs are traced afresh with it and again without it afterwards."""
    log, orig = [], jmoe.sparse_mlp

    def counting(mp, x, *, num_experts, top_k, norm_topk_prob, capacity=None, live=None, ep=False):
        s = x.shape[0]
        c = s if capacity is None else min(capacity, s)
        _, idx = jax.lax.top_k(jax.nn.softmax((x @ mp["router"]).astype(jnp.float32), axis=-1), top_k)
        oh = jax.nn.one_hot(idx, num_experts, dtype=jnp.int32)
        if live is not None:
            oh = oh * live.astype(jnp.int32)[:, None, None]
        pos = jnp.cumsum(oh.transpose(1, 0, 2).reshape(top_k * s, num_experts), axis=0) - 1
        pos = pos.reshape(top_k, s, num_experts).transpose(1, 0, 2)
        dropped = jnp.sum((pos >= c) & (oh > 0))
        jax.debug.callback(lambda d: log.append((s, c, int(d))), dropped, ordered=True)
        return orig(mp, x, num_experts=num_experts, top_k=top_k, norm_topk_prob=norm_topk_prob,
                    capacity=capacity, live=live, ep=ep)

    jmoe.sparse_mlp = counting
    jax.clear_caches()
    try:
        yield log
    finally:
        jmoe.sparse_mlp = orig
        jax.clear_caches()


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def engines(stacks, **ff_kw):
    jcfg, tcfg, jp, tp = stacks
    ff = dict(FF, **ff_kw)
    return (JaxEngine(jp, jcfg, JaxFF(**ff), attn_impl="einsum", compact_pre_event=True),
            CompressionEngine(tp, tcfg, FrameFusionConfig(**ff), attn_impl="einsum"))


@pytest.mark.parametrize("mode", ["fused", "planned", "segmented"])
def test_engine_matches_jax(stacks, jax_drops, mode):
    """Each executor against JAX's at factor 4.0 (lossless here) and 1.25
    (experts overflow): events, valid length, cache lengths, the drops of
    every MLP call (rows, capacity, dropped), logits, every layer's cached
    keys (the tokens each layer kept), then 5 greedy tokens.
    The planned executor runs at PlanHistory's buckets (a fused run of the
    prompt first, on both sides), as a server's "auto" prefill does; its
    capacity comes from those buckets' rows, pad rows included, as JAX's
    does, and at 1.25 its experts overflow too."""
    eng_j, eng_t = engines(stacks)
    h, pt, pos, start, n_img = build_inputs(seed=1, coherent=0.35)
    if mode == "planned":
        for eng in (eng_j, eng_t):
            eng.prefill(h, pt, pos, 6, start, n_img)
    jax.effects_barrier()
    jax_drops.clear()
    res_j = eng_j.prefill(h, pt, pos, 6, start, n_img, mode=mode)
    jax.effects_barrier()
    with tmoe.record_drops() as drops:
        res_t = eng_t.prefill(h, pt, pos, 6, start, n_img, mode=mode)
    got = [(s, c, int(d)) for s, c, d in drops]
    assert res_t.mode == res_j.mode == mode
    assert mode != "planned" or res_t.plan_source == res_j.plan_source == "history"
    assert events(res_t) == events(res_j) and len(events(res_t)) >= 3
    assert res_t.valid_len == res_j.valid_len
    assert [c[2] for c in res_t.layer_caches] == [c[2] for c in res_j.layer_caches]
    assert got == jax_drops and len(got) == stacks[0].num_layers
    if stacks[0].moe_capacity_factor < 2:
        assert sum(d for _, _, d in got) > 0  # the tight factor drops
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    for (kt, _, n), (kj, _, _) in zip(res_t.layer_caches, res_j.layer_caches):  # the keep sets, layer by layer
        np.testing.assert_allclose(kt[:n].numpy(), np.asarray(kj[:n], np.float32), atol=TOL, rtol=TOL)
    assert eng_t.generate(res_t, 5) == eng_j.generate(res_j, 5)


def _prompts():
    return [build_inputs(seed=s, coherent=c) for s, c in ((0, 0.3), (1, 0.35), (2, 0.45))]


def test_decode_entry_points_match_jax(tight):
    """generate (the graph's step body eagerly), generate_batch over the
    lockstep-batched planned prefill and generate_spec give JAX's tokens;
    the batched prefill's events equal JAX's; generate_spec_batch gives
    generate_batch's tokens."""
    eng_j, eng_t = engines(tight)
    ps = _prompts()
    res_j = eng_j.prefill_planned_batch(ps, patch_num=6)
    res_t = eng_t.prefill_planned_batch(ps, patch_num=6)
    assert [events(r) for r in res_t] == [events(r) for r in res_j]
    assert [r.mode for r in res_t] == [r.mode for r in res_j]
    for a, b in zip(res_t, res_j):
        np.testing.assert_allclose(a.logits.numpy(), np.asarray(b.logits), atol=TOL, rtol=TOL)
    want = eng_j.generate_batch(res_j, 6)
    assert eng_t.generate_batch(res_t, 6) == want
    assert eng_t.generate_spec_batch(res_t, 6, draft_len=2) == want
    solo_j = eng_j.prefill(*ps[0][:3], 6, *ps[0][3:])
    solo_t = eng_t.prefill(*ps[0][:3], 6, *ps[0][3:])
    toks = eng_j.generate(solo_j, 6)
    assert eng_t.generate(solo_t, 6) == toks
    assert eng_t.generate_spec(solo_t, 6, draft_len=3) == eng_j.generate_spec(solo_j, 6, draft_len=3) == toks


def test_model_entry_points_and_serving_on_moe(tight):
    """``FrameFusionModel`` runs a MoE config through generate, generate_batch
    and ``speculative=True``, and its ServingLoop (2 slots, 2 requests)
    gives each request its solo greedy tokens."""
    _, tcfg, _, tp = tight
    m = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg, params=tp), 0.5, 0.8, 0.05)
    m.ff = m.ff.replace(schedule_num_layers=6, bucket=32)
    inputs = [PrefillInputs(h, pt, pos, 6, s0, n) for h, pt, pos, s0, n in _prompts()[:2]]
    solo = [m.generate(inp, 6)[0] for inp in inputs]
    assert [m.generate(inp, 6, speculative=True, draft_len=2)[0] for inp in inputs] == solo
    assert m.generate_batch(inputs, 6)[0] == solo
    loop = m.serving_loop(max_slots=2, max_new_cap=8, chunk_steps=3, prefix_cap=128)
    ids = [loop.submit(ServeRequest(inp, max_new_tokens=6)) for inp in inputs]
    out = loop.run()
    assert [out[i].tokens for i in ids] == solo


def test_int8_decisions_and_decode(tight):
    """int8 weights (JAX's ``test_moe_engine_int8_decisions_and_decode``):
    the expert stacks quantize 4-D per (layer, expert, output channel) as
    JAX's do, the shared expert goes int8, the router keeps its dtype; the
    int8 engine's decisions equal the fp32 run's and JAX's int8 run's, its
    logits JAX's, and generate_spec gives generate's tokens."""
    jcfg, tcfg, jp, tp = tight
    jq8 = jax_quantize(jax.tree.map(jnp.copy, jp))
    tq8 = quantize_params_int8({k: (dict(v) if isinstance(v, dict) else v.clone()) for k, v in tp.items()})
    for name in QUANTIZED_LAYER_WEIGHTS:
        if name in ("w_gate", "w_up", "w_down"):
            assert tq8["layers"][name]["q8"].ndim == 4 and tq8["layers"][name]["scale"].ndim == 3
        if name in tq8["layers"]:
            assert torch.equal(tq8["layers"][name]["q8"], torch.from_numpy(np.array(jq8["layers"][name]["q8"])))
    assert isinstance(tq8["layers"]["sw_up"], dict) and not isinstance(tq8["layers"]["router"], dict)
    assert not isinstance(tq8["layers"]["shared_gate"], dict)
    h, pt, pos, start, n_img = build_inputs(seed=0, coherent=0.3)
    eng_j, eng_t = engines((jcfg, tcfg, jq8, tq8))
    _, eng_f = engines(tight)
    res_j, res_t = (e.prefill(h, pt, pos, 6, start, n_img) for e in (eng_j, eng_t))
    res_f = eng_f.prefill(h, pt, pos, 6, start, n_img)
    assert events(res_t) == events(res_j) == events(res_f) and res_t.valid_len == res_f.valid_len
    np.testing.assert_allclose(res_t.logits.numpy(), np.asarray(res_j.logits), atol=TOL, rtol=TOL)
    toks = eng_t.generate(res_t, 5)
    assert toks == eng_j.generate(res_j, 5)
    assert eng_t.generate_spec(eng_t.prefill(h, pt, pos, 6, start, n_img), 5, draft_len=2) == toks


def test_verify_batch_over_64_rows_stays_on_the_kernels(tight, monkeypatch):
    """A batched verify of B * K = 72 rows (a serving loop's many slots and
    drafts) on int8 weights with the int8 head: the "flash" step runs its
    rows in blocks of 64 and 8, keeps the routed experts on kernels C and D
    (512 and 64 routed rows a layer, nine launches each on the card) and
    the head on C, and never gathers an expert (the plain
    path would cast every routed expert a layer); its logits and new keys
    are JAX's verify (which gathers, in fp32) within the bf16 bounds of the
    kernels' plain versions, and each sequence's logits are those of that
    sequence verified alone (24 rows, one launch) within 1e-4."""
    jcfg, tcfg, jp, _ = tight
    jq8 = jax_quantize(jax.tree.map(jnp.copy, jp), quantize_lm_head=True)
    tq8 = tq.params_from_numpy(jax.device_get(jq8), device="cpu")
    assert isinstance(tq8["lm_head"], dict)
    rng = np.random.default_rng(11)
    b, kq, s_pool, n_l = 3, 24, 64, tcfg.num_layers
    hk, hd = tcfg.num_kv_heads, tcfg.head_dim_
    k_pool, v_pool = ((rng.standard_normal((n_l, b, s_pool, hk, hd)) * 0.5).astype(np.float32) for _ in range(2))
    embs = (rng.standard_normal((b, kq, tcfg.hidden_size)) * 0.05).astype(np.float32)
    lens = [[20, 17, 23]] * n_l
    pos = (np.array(lens[0])[:, None] + np.arange(kq)[None]).astype(np.int32)
    mask = np.zeros((b, s_pool), bool)
    lj, kj, _, _, _ = jq.verify_step_batch(jq8, jnp.asarray(embs), jnp.asarray(pos), jnp.asarray(k_pool),
                                           jnp.asarray(v_pool), jnp.asarray(lens, jnp.int32), jnp.asarray(mask),
                                           jnp.int32(40), jnp.int32(0), jcfg)
    calls = []
    for name in ("matvec_routed", "matvec_routed_gateup", "matvec_q8"):
        real = getattr(tmv, name)
        monkeypatch.setattr(tmv, name, lambda x, *a, _n=name, _r=real: calls.append((_n, x.shape[0])) or _r(x, *a))
    monkeypatch.setattr(tq, "_gather_expert", lambda *a: pytest.fail("the flash verify gathered an expert"))

    def verify(rows):
        return tq.verify_step_batch(tq8, torch.from_numpy(embs[rows]), pos[rows],
                                    torch.from_numpy(k_pool[:, rows].copy()), torch.from_numpy(v_pool[:, rows].copy()),
                                    [[r[i] for i in rows] for r in lens], torch.from_numpy(mask[rows]), 40, 0, tcfg,
                                    attn_impl="flash")

    lt, kt, _, _, _ = verify([0, 1, 2])
    blocks = (tmv.MAX_ROWS, b * kq - tmv.MAX_ROWS)  # 64 + 8 rows; 512 + 64 routed rows
    routed = [(name, r * tcfg.num_experts_per_tok) for r in blocks
              for name in ("matvec_routed_gateup", "matvec_routed")]
    assert calls == routed * n_l + [("matvec_q8", r) for r in blocks]
    scale = float(np.abs(np.asarray(lj)).max())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=STACK_BF16_TOL * scale)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=BF16_TOL * float(np.abs(np.asarray(kj)).max()))
    for i in range(b):
        solo = verify([i])[0][0]
        np.testing.assert_allclose(lt[i].numpy(), solo.numpy(), rtol=0, atol=TOL * scale)


def test_baseline_engine_refuses_moe(tight):
    _, tcfg, _, tp = tight
    with pytest.raises(NotImplementedError, match="MoE"):
        BaselineEngine(tp, tcfg, "fastv", {"fastv_k": 2, "fastv_r": 0.5})


HF_GEOM = dict(vocab_size=160, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
               num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48, shared_expert_intermediate_size=96,
               norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[], tie_word_embeddings=False)


@pytest.fixture(scope="module")
def hf_moe(tmp_path_factory):
    """A random HF ``Qwen2MoeForCausalLM`` saved as a hub dir (no download)."""
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

    torch.manual_seed(0)
    model = Qwen2MoeForCausalLM(Qwen2MoeConfig(**HF_GEOM, attn_implementation="eager")).eval()
    hub = tmp_path_factory.mktemp("qwen2_moe_hub")
    model.save_pretrained(hub)
    return model, str(hub)


def _port_greedy(m, ids, n_new):
    """Prefill logits (S, V) and n_new greedy tokens through the port's
    dense prefill and decode step (lossless capacity: HF's semantics)."""
    eng = CompressionEngine(m.params, m.cfg.replace(moe_capacity_factor=1e9), FrameFusionConfig(), attn_impl="einsum")
    emb = tq.embed(m.params, torch.as_tensor(ids))
    cos, sin = tq.positions_cos_sin(torch.arange(len(ids)), eng.cfg)
    h, _, _ = tq.run_layers(m.params, emb, cos, sin, eng.cfg, want_caches=False)
    logits = tq.final_logits(m.params, h, eng.cfg)
    res = eng.dense_prefill(emb, np.arange(len(ids)))
    return logits, eng.generate(res, n_new)


@pytest.mark.parametrize("load", ["fp32", "bf16", "int8"])
def test_loader_matches_hf(hf_moe, load):
    """``weights.load_checkpoint`` on the hub dir: the config's expert fields,
    the llava_video family, the expert stacks (L, E, K, N); prefill logits
    and 6 greedy tokens against HF's (fp32: logits to 3e-4 as JAX's test;
    bf16: HF's model in bf16, logits to 3e-2 of the largest; int8 on load:
    HF's model with the dequantized weights, logits to 3e-4)."""
    model, hub = hf_moe
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(hub)  # the card by default, as every loader
    dtype = torch.bfloat16 if load == "bf16" else torch.float32
    m = load_checkpoint(hub, dtype=dtype, quantize="int8" if load == "int8" else None, device="cpu")
    assert m.family == "llava_video" and m.cfg.is_moe and m.vision is None
    assert (m.cfg.num_experts, m.cfg.num_experts_per_tok, m.cfg.moe_intermediate_size,
            m.cfg.shared_expert_intermediate_size) == (4, 2, 48, 96)
    wg = m.params["layers"]["w_gate"]
    assert tuple((wg["q8"] if load == "int8" else wg).shape) == (2, 4, 64, 48)
    ref = model
    if load == "bf16":
        ref = type(model)(model.config).eval()
        ref.load_state_dict(model.state_dict())
        ref = ref.to(torch.bfloat16)
    if load == "int8":
        from framefusion_tpu_torch.ops.quant import dequantize_weight

        ref = type(model)(model.config).eval()
        ref.load_state_dict(model.state_dict())
        lay = m.params["layers"]
        with torch.no_grad():
            for i, layer in enumerate(ref.model.layers):
                for j, ex in enumerate(layer.mlp.experts):
                    for name, lin in (("w_gate", ex.gate_proj), ("w_up", ex.up_proj), ("w_down", ex.down_proj)):
                        lin.weight.copy_(dequantize_weight({"q8": lay[name]["q8"][i, j],
                                                            "scale": lay[name]["scale"][i, j]}).T)
                for name, lin in (("wq", layer.self_attn.q_proj), ("wk", layer.self_attn.k_proj),
                                  ("wv", layer.self_attn.v_proj), ("wo", layer.self_attn.o_proj),
                                  ("sw_gate", layer.mlp.shared_expert.gate_proj),
                                  ("sw_up", layer.mlp.shared_expert.up_proj),
                                  ("sw_down", layer.mlp.shared_expert.down_proj)):
                    lin.weight.copy_(dequantize_weight({"q8": lay[name]["q8"][i], "scale": lay[name]["scale"][i]}).T)
    ids = np.random.default_rng(2).integers(0, HF_GEOM["vocab_size"], size=13)
    with torch.no_grad():
        hf_logits = ref(torch.tensor(ids[None])).logits[0].float()
        hf_new = ref.generate(torch.tensor(ids[None]), max_new_tokens=6, do_sample=False, pad_token_id=0)[0, 13:]
    logits, toks = _port_greedy(m, ids, 6)
    tol = 3e-2 * float(hf_logits.abs().max()) if load == "bf16" else 3e-4
    np.testing.assert_allclose(logits.float().numpy(), hf_logits.numpy(), atol=tol, rtol=0 if load == "bf16" else tol)
    assert toks == hf_new.tolist()
    d = model.config.to_dict()
    d["architectures"] = ["Qwen2MoeForCausalLM"]
    assert llm_config_from_hf(d)[1].num_experts == 4
