"""PyTorch port vs the JAX package: tensor-parallel serving across ranks.

The port's ranks are CPU processes over ``gloo`` (``parallel/launch.spawn``
with ``device="cpu"``); JAX's sharded run is GSPMD over the 8 virtual CPU
devices of ``tests/conftest.py``, as ``tests/test_parallel.py`` runs it.
The same weights (JAX's ``init_params``, fetched as numpy) and prompts go
through both. Held, as JAX's own sharded tests hold JAX:

* the compression events equal on every rank and equal JAX's sharded run's,
  the final lengths and each layer's cache length too;
* greedy, speculative and served tokens equal;
* logits within 2e-3 (fp32 on both sides; the ranks sum their partial
  products in another order than one device does).

One spawn of four ranks runs every engine job of this module (the ranks'
start-up is most of a spawn's time). The kernels' plain versions
(``attn_impl="flash"``) under TP are held to the port's own one-process
engine, and the expert-parallel and tensor-parallel MoE stacks to JAX's
one-device MoE engine.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import write_fixture
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import qwen25_vl_72b_config as jax_72b
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.config import tiny_moe_llm_config as jax_tiny_moe
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.parallel import sharding as jsharding
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.serving import ServeRequest as JaxRequest
from framefusion_tpu.runtime.serving import ServingLoop as JaxLoop
from framefusion_tpu_torch import weights
from framefusion_tpu_torch.config import FrameFusionConfig, qwen25_vl_72b_config, tiny_llm_config, tiny_moe_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.parallel import launch, sharding, workers
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from test_core import make_sequence

# Tiny shapes: one intra-op thread each (pytest-xdist workers share the cores).
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="JAX's sharded runs need 8 devices")

TOL = 2e-3  # JAX's own sharded bound (tests/test_parallel.py)
WORLD = 4
FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)
LOOP = dict(max_slots=2, max_new_cap=10, chunk_steps=3, prefix_cap=128)


def _prompt(cfg_hidden, seed=0, coherent=0.8, pos3=False):
    rng = np.random.default_rng(seed)
    h, pt, img_start, n_img = make_sequence(rng, 4, 6, 10, 3, hidden=cfg_hidden, coherent=coherent)
    h = (h * 0.05).astype(np.float32)
    pos = np.arange(len(pt), dtype=np.int32)
    return (h, pt, np.tile(pos, (3, 1)) if pos3 else pos, 6, img_start, n_img)


def _events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def _jax_sharded(params, cfg, tensor, run):
    mesh = jsharding.make_mesh(jax.devices()[:8], tensor=tensor)
    with mesh:
        return run(jsharding.shard_params(params, cfg, mesh))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Every case's job for the ranks and its JAX reference: the ranks run
    in one spawn, started first, while this process runs JAX."""
    refs, jobs, todo = {}, [], {}

    # Fused prefill (TestShardedInference.test_fused_prefill_matches_unsharded).
    jcfg, tcfg = jax_tiny(num_layers=4), tiny_llm_config(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    jff = JaxFF(**FF)
    fused = _prompt(jcfg.hidden_size, coherent=0.8)
    spec_p = _prompt(jcfg.hidden_size, coherent=0.5)
    serve_ps = [_prompt(jcfg.hidden_size, seed=s, coherent=0.5) for s in (0, 1, 2)]

    def tp2_run(sharded):
        eng = JaxEngine(sharded, jcfg, jff, attn_impl="einsum")
        res = eng.prefill(*fused)
        res_s = eng.prefill(*spec_p)
        spec = eng.generate_spec(res_s, 12, draft_len=4)
        loop = JaxLoop(eng, **LOOP)
        ids = [loop.submit(JaxRequest(JaxInputs(*p), max_new_tokens=10)) for p in serve_ps]
        served = loop.run()
        return {"fused": (_events(res), res.valid_len, [int(c[2]) for c in res.layer_caches], np.asarray(res.logits)),
                "spec": spec, "serve": [served[i].tokens for i in ids]}

    todo["tp2"] = lambda: _jax_sharded(jp, jcfg, 2, tp2_run)
    ff = FrameFusionConfig(**FF)
    params = _np_tree(jp)
    steps = [dict(op="prefill", prompt=fused), dict(op="spec", prompt=spec_p, n=12, draft_len=4),
             dict(op="serve", prompts=serve_ps, n=10, loop=LOOP)]
    jobs.append(dict(kind="tp", cfg=tcfg, ff=ff, params=params, tensor=2, attn_impl="einsum", steps=steps))

    # Dense prefill and decode (test_dense_prefill_and_decode_sharded).
    jcfg2, tcfg2 = jax_tiny(num_layers=2), tiny_llm_config(num_layers=2)
    jp2 = jq.init_params(jcfg2, jax.random.PRNGKey(1))
    h = (np.random.default_rng(1).standard_normal((40, jcfg2.hidden_size)) * 0.05).astype(np.float32)
    dense = (h, np.zeros(40, np.int32), np.arange(40, dtype=np.int32), 6, 0, 0)

    def dense_run(sharded):
        eng = JaxEngine(sharded, jcfg2, JaxFF(), attn_impl="einsum")
        res = eng.dense_prefill(h, dense[2])
        return np.asarray(res.logits), eng.generate_greedy(res, max_new_tokens=4)

    todo["dense"] = lambda: _jax_sharded(jp2, jcfg2, 2, dense_run)
    jobs.append(dict(kind="tp", cfg=tcfg2, ff=FrameFusionConfig(), params=_np_tree(jp2), tensor=2,
                     attn_impl="einsum", steps=[dict(op="dense_greedy", prompt=dense, n=4)]))

    # The deep TP-4 prefill on a 72B-shaped mRoPE stack with 4 capture rows
    # (TestLargeModelSharding.test_deep_tp4_compressed_prefill).
    shape = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=6, num_heads=8, num_kv_heads=4,
                 head_dim=16, mrope_section=(2, 3, 3))
    jcfg3, tcfg3 = jax_72b(**shape, dtype=jnp.float32), qwen25_vl_72b_config(**shape, dtype=torch.float32)
    jp3 = jq.init_params(jcfg3, jax.random.PRNGKey(0))
    ff3 = dict(FF, schedule_num_layers=6, num_importance_queries=4)
    deep = _prompt(jcfg3.hidden_size, coherent=0.55, pos3=True)  # prunes: 4 capture rows

    def deep_run(sharded):
        eng = JaxEngine(sharded, jcfg3, JaxFF(**ff3), attn_impl="einsum")
        res = eng.prefill(*deep)
        return (_events(res), res.valid_len, np.asarray(res.logits)), eng.generate_greedy(res, max_new_tokens=3)

    todo["deep"] = lambda: _jax_sharded(jp3, jcfg3, 4, deep_run)
    jobs.append(dict(kind="tp", cfg=tcfg3, ff=FrameFusionConfig(**ff3), params=_np_tree(jp3), tensor=4,
                     attn_impl="einsum", steps=[dict(op="greedy", prompt=deep, n=3)]))

    # The kernels' plain versions under TP 2, and TP 4 on 8 / 4 heads,
    # against the port's own one-process engine.
    tcfg4 = tiny_llm_config(num_layers=4, num_heads=8, num_kv_heads=4)
    p4 = tq.init_params(tcfg4, torch.Generator().manual_seed(4))
    flash_p = _prompt(tcfg4.hidden_size, seed=2, coherent=0.5)
    eng = CompressionEngine(p4, tcfg4, ff, attn_impl="flash")
    res = eng.prefill(*flash_p)
    refs["flash"] = (workers.result_of(res), eng.generate_greedy(res, 8), eng.generate_spec(res, 8))
    np4 = {k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict) else v.numpy())
           for k, v in p4.items()}
    for t in (2, 4):
        jobs.append(dict(kind="tp", cfg=tcfg4, ff=ff, params=np4, tensor=t, attn_impl="flash",
                         steps=[dict(op="greedy", prompt=flash_p, n=8), dict(op="spec", prompt=flash_p, n=8),
                                dict(op="sampled", prompt=flash_p, n=8, temperature=1.0)]))

    # A MoE stack: experts over 2 and 4 ranks (expert parallelism) and over
    # the tensor group (TP 2), against JAX's one-device MoE engine.
    jcfg5, tcfg5 = jax_tiny_moe(num_layers=4), tiny_moe_llm_config(num_layers=4)
    jp5 = jq.init_params(jcfg5, jax.random.PRNGKey(5))
    moe_p = _prompt(jcfg5.hidden_size, seed=3, coherent=0.5)

    def moe_run():
        jeng = JaxEngine(jp5, jcfg5, jff, attn_impl="einsum")
        res5 = jeng.prefill(*moe_p)
        return _events(res5), res5.valid_len, np.asarray(res5.logits), jeng.generate_greedy(res5, 6)

    todo["moe"] = moe_run
    moe_steps = [dict(op="greedy", prompt=moe_p, n=6)]
    for kind, width in (("ep", 2), ("ep", 4), ("tp", 2)):
        job = dict(kind=kind, cfg=tcfg5, ff=ff, params=_np_tree(jp5), attn_impl="einsum", steps=moe_steps)
        job["expert" if kind == "ep" else "tensor"] = width
        jobs.append(job)

    # A tiny HF checkpoint, loaded a shard a rank (weights.load_checkpoint(mesh=))
    # and whole in this process.
    path = write_fixture(tmp_path_factory.mktemp("ckpt"), "llava_video")
    whole = weights.load_checkpoint(path, dtype=torch.float32, device="cpu")
    ck_p = _prompt(whole.cfg.hidden_size, seed=4, coherent=0.5)
    eng = CompressionEngine(whole.params, whole.cfg, ff, attn_impl="einsum")
    res = eng.prefill(*ck_p)
    refs["checkpoint"] = (workers.result_of(res), eng.generate_greedy(res, 6))
    jobs.append(dict(kind="tp", cfg=whole.cfg, ff=ff, checkpoint=path, tensor=2, attn_impl="einsum",
                     steps=[dict(op="greedy", prompt=ck_p, n=6)]))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, workers.run_jobs, WORLD, jobs, backend="gloo", device="cpu",
                            timeout_s=240)
        refs.update({name: run() for name, run in todo.items()})
        outs = ranks.result()
    return refs, outs, jobs


def _same_on_ranks(outs, j, key="events"):
    steps = [o[j]["steps"] for o in outs]
    return all([s.get(key) for s in st] == [s.get(key) for s in steps[0]] for st in steps)


def test_every_rank_makes_the_same_decisions(cases):
    _, outs, jobs = cases
    for j in range(len(jobs)):
        assert _same_on_ranks(outs, j), f"job {j}: the ranks' events differ"
        assert _same_on_ranks(outs, j, "tokens"), f"job {j}: the ranks' tokens differ"


def test_fused_prefill_tp2_matches_jax_sharded(cases):
    refs, outs, _ = cases
    events, valid, lens, logits = refs["tp2"]["fused"]
    got = outs[0][0]["steps"][0]
    assert got["events"] == events and got["valid_len"] == valid and got["lens"] == lens
    np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)


def test_dense_prefill_and_decode_tp2_match_jax_sharded(cases):
    refs, outs, _ = cases
    logits, tokens = refs["dense"]
    got = outs[0][1]["steps"][0]
    assert got["tokens"] == tokens
    np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)


def test_spec_decode_tp2_matches_jax_sharded(cases):
    refs, outs, _ = cases
    assert outs[0][0]["steps"][1]["tokens"] == refs["tp2"]["spec"]


def test_serving_loop_tp2_matches_jax_sharded(cases):
    refs, outs, _ = cases
    assert outs[0][0]["steps"][2]["tokens"] == refs["tp2"]["serve"]


def test_deep_tp4_mrope_prefill_matches_jax_sharded(cases):
    refs, outs, _ = cases
    (events, valid, logits), tokens = refs["deep"]
    got = outs[0][2]["steps"][0]
    assert any(e[1] == "prune" for e in events), "want a capture layer (4 rows)"
    assert got["events"] == events and got["valid_len"] == valid
    assert got["tokens"] == tokens and len(tokens) == 3
    np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)
    assert outs[0][2]["local_heads"] == 2


@pytest.mark.parametrize("job", [3, 4], ids=["tp2", "tp4"])
def test_kernels_plain_versions_under_tp_match_one_process(cases, job):
    refs, outs, _ = cases
    res, greedy, spec = refs["flash"]
    got = outs[0][job]["steps"]
    assert got[0]["events"] == res["events"] and got[0]["lens"] == res["lens"]
    assert got[0]["tokens"] == greedy and got[1]["tokens"] == spec
    np.testing.assert_allclose(got[0]["logits"], res["logits"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("job", [3, 4], ids=["tp2", "tp4"])
def test_sampled_decode_under_tp_takes_the_first_ranks_uniforms(cases, job):
    """Each rank samples from its own generator (seeded with its place in
    its group); the engine hands every rank its group's first rank's
    uniforms, so every rank feeds the same tokens back (the ranks of the
    other data replica too: their first rank's seed is also 0)."""
    refs, outs, _ = cases
    sampled = [o[job]["steps"][2]["tokens"] for o in outs]
    assert all(t == sampled[0] for t in sampled)
    assert sampled[0] != refs["flash"][1] and len(set(sampled[0])) > 1


@pytest.mark.parametrize("job", [5, 6, 7], ids=["ep2", "ep4", "tp2"])
def test_moe_stack_across_ranks_matches_jax(cases, job):
    refs, outs, jobs = cases
    events, valid, logits, tokens = refs["moe"]
    got = outs[0][job]["steps"][0]
    assert got["events"] == events and got["valid_len"] == valid and got["tokens"] == tokens
    np.testing.assert_allclose(got["logits"], logits, rtol=TOL, atol=TOL)
    width = jobs[job].get("expert", jobs[job].get("tensor"))
    assert outs[0][job]["shapes"]["w_gate"][1] == 4 // width  # this rank's experts


def test_load_checkpoint_with_a_mesh_loads_each_ranks_shard(cases):
    """``weights.load_checkpoint(path, mesh=)`` on each of 2 tensor ranks:
    the model holds the rank's shard (heads, MLP width and vocabulary
    halved) and its engine's prefill and greedy tokens are the whole
    checkpoint's in one process."""
    refs, outs, jobs = cases
    res, tokens = refs["checkpoint"]
    d, hd = jobs[8]["cfg"].hidden_size, jobs[8]["cfg"].head_dim_
    for o in outs:
        got = o[8]
        assert got["shapes"]["wq"] == (2, d, 2 * hd) and got["shapes"]["wk"] == (2, d, hd)
        assert got["shapes"]["w_down"] == (2, 48, d) and got["shapes"]["embed"] == (64, d)
        assert got["shapes"]["lm_head"] == (d, 64) and got["local_heads"] == 2
        step = got["steps"][0]
        assert step["events"] == res["events"] and step["lens"] == res["lens"] and step["tokens"] == tokens
        np.testing.assert_allclose(step["logits"], res["logits"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["tiny", "moe", "tied", "no_bias"])
def test_param_pspecs_match_jax(name):
    kw = {"tied": dict(tie_word_embeddings=True), "no_bias": dict(qkv_bias=False)}.get(name, {})
    jcfg = (jax_tiny_moe if name == "moe" else jax_tiny)(**kw)
    tcfg = (tiny_moe_llm_config if name == "moe" else tiny_llm_config)(**kw)
    want = jax.tree.map(tuple, jsharding.param_pspecs(jcfg),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert sharding.param_pspecs(tcfg) == want


@pytest.mark.parametrize("job,tensor", [(0, 2), (2, 4)], ids=["tiny_tp2", "deep_tp4"])
def test_rank_shards_match_jax_addressable_shards(cases, job, tensor):
    """Each rank's leaf shapes are JAX's shard shapes on the device at the
    same tensor index; the rank's shard is its own block of the whole."""
    _, outs, jobs = cases
    jcfg = jax_tiny(num_layers=4) if job == 0 else jax_72b(
        vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=6, num_heads=8, num_kv_heads=4,
        head_dim=16, mrope_section=(2, 3, 3), dtype=jnp.float32)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    mesh = jsharding.make_mesh(jax.devices()[:8], tensor=tensor)
    sharded = jsharding.shard_params(jp, jcfg, mesh)
    want = {k: v.addressable_shards[0].data.shape for k, v in sharded["layers"].items()}
    want.update({k: sharded[k].addressable_shards[0].data.shape for k in ("embed", "lm_head")})
    for rank in range(WORLD):
        assert outs[rank][job]["shapes"] == want
    whole = jobs[job]["params"]["layers"]["wq"]
    n = whole.shape[2] // tensor
    rank_shard = sharding.shard_leaf(torch.from_numpy(whole.copy()), (None, None, "tensor"), 1, tensor)
    np.testing.assert_array_equal(rank_shard.numpy(), whole[:, :, n:2 * n])
    assert rank_shard.is_contiguous()


def test_local_config_splits_the_72b_geometry():
    cfg = qwen25_vl_72b_config()
    for t in (2, 4, 8):
        local = sharding.local_config(cfg, t)
        assert (local.num_heads, local.num_kv_heads, local.intermediate_size) == (64 // t, 8 // t, 29568 // t)
        assert local.head_dim_ == 128 and local.vocab_size == cfg.vocab_size
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_config(cfg, 16)  # 8 KV heads


def test_int8_head_pads_to_the_kernel_width_a_rank():
    """An int8 head is padded to 16 columns a rank before its split (the
    kernel reads 16 int8 columns at a time); the pad's logits are cut."""
    from framefusion_tpu_torch.ops.quant import quantize_head

    cfg = tiny_llm_config(vocab_size=500)
    head = quantize_head(torch.randn(cfg.hidden_size, 500, generator=torch.Generator().manual_seed(0)))
    padded = sharding._pad_vocab({"embed": torch.zeros(500, cfg.hidden_size), "lm_head": head}, cfg, 4)
    assert padded["lm_head"]["q8"].shape[1] == 512 and padded["embed"].shape[0] == 500
    assert (padded["lm_head"]["q8"][:, 500:] == 0).all() and (padded["lm_head"]["scale"][500:] == 1e-12).all()


def test_spawn_raises_a_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match=r"rank 0 of 2 failed:(.|\n)*KeyError: 'no such job'"):
        launch.spawn(workers.run_jobs, 2, [{"kind": "no such job"}], backend="gloo", device="cpu", timeout_s=60)


def test_spawn_fails_a_rank_that_outlasts_its_time():
    with pytest.raises(TimeoutError, match=r"ranks \[.*1.*\] of 2 still running"):
        launch.spawn(workers.run_jobs, 2, [{"kind": "hold", "rank": 1, "seconds": 120}], backend="gloo",
                     device="cpu", timeout_s=6)


def test_spawn_takes_the_backend_and_device_explicitly():
    with pytest.raises(ValueError, match="backend must be one of"):
        launch.spawn(workers.run_jobs, 2, [], backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="runs on the card"):
        launch.spawn(workers.run_jobs, 2, [], backend="nccl", device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="nccl needs a card a rank"):
            launch.spawn(workers.run_jobs, 2, [], backend="nccl", device="cuda")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_nccl_world_of_one_graph_is_the_unsharded_decode(cuda):
    """A world of one over NCCL: the decode graph of the engine with a mesh
    captures its all-reduces (none runs outside the replays) and gives the
    tokens and logits of the engine without a mesh, bit for bit."""
    cfg = tiny_llm_config(num_layers=2, hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=1,
                          head_dim=128, dtype=torch.bfloat16)
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1, bucket=32)
    job = dict(kind="nccl_one", cfg=cfg, ff=ff, seed=1, n=8, prompt={"video": dict(seed=0, n_frames=8, patch_num=8)})
    out = launch.spawn(workers.run_jobs, 1, [job], backend="nccl", device="cuda", timeout_s=300)[0][0]
    a, m = out["alone"], out["mesh"]
    assert a["captured"] and m["captured"] and m["replays"] == 7
    assert m["collectives"] > 0 and m["collectives_in_replays"] == 0
    assert a["tokens"] == m["tokens"] and a["events"] == m["events"]
    assert np.array_equal(a["logits"], m["logits"]) and np.array_equal(a["prefill_logits"], m["prefill_logits"])


@pytest.mark.gpu
@pytest.mark.parametrize("tensor", [2, 4])
def test_cuda_kernels_at_qwen2_7b_tp_shapes_match_plain(cuda, tensor):
    """Kernels A, B, C, D and G at a rank's shapes of Qwen2-7B under TP 2
    and 4 (heads, KV heads and the MLP width divided; the int8 head's
    vocabulary slice) against their plain versions: A per (row, head) to
    2e-2 of the row's largest output, B and C / D to 1e-4 of the largest."""
    from framefusion_tpu_torch.ops.attention import capture_rows
    from framefusion_tpu_torch.ops.kernels import decode_attention as da
    from framefusion_tpu_torch.ops.kernels import flash_prefill as fp
    from framefusion_tpu_torch.ops.kernels import matvec_q8 as mv
    from framefusion_tpu_torch.ops.quant import quantize_head, quantize_weight

    gen = torch.Generator(device=cuda).manual_seed(tensor)
    hq, hk, d, inter, vocab = 28 // tensor, 4 // tensor, 3584, 18944 // tensor, 152064

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(torch.bfloat16)

    s = 2048
    q, k, v = rand(s, hq, 128), rand(s, hk, 128), rand(s, hk, 128)
    kv = torch.rand((s,), generator=gen, device=cuda) >= 0.45
    kv[-1] = True
    out, m, l = fp.flash_attn_fwd(q, k, v, kv)
    ref, _, _ = fp.flash_attn_fwd_plain(q, k, v, kv)
    err = (out.float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1).clamp(min=1e-30)
    assert err.max() <= 2e-2
    rows = capture_rows(s, 1, None, kv)
    imp = fp.attn_importance_rows(q, k, rows, m, l, kv)
    imp_ref = fp.attn_importance_rows_plain(q, k, rows, m, l, kv)
    assert (imp - imp_ref).abs().max() <= 1e-4 * imp_ref.abs().max()

    x = rand(1, d)
    w = {n: quantize_weight(rand(2, kk, nn, scale=0.02)) for n, (kk, nn) in
         {"q": (d, hq * 128), "k": (d, hk * 128), "v": (d, hk * 128), "o": (hq * 128, d), "g": (d, inter),
          "u": (d, inter), "down": (inter, d)}.items()}
    got = mv.gemv_stacked(x, [w["q"]["q8"], w["k"]["q8"], w["v"]["q8"]], 1)
    want = mv.gemv_stacked_plain(x, [w["q"]["q8"], w["k"]["q8"], w["v"]["q8"]], 1)
    for gt, wt in zip(got, want):
        assert (gt - wt).abs().max() <= 1e-4 * wt.abs().max()
    for name in ("o", "down"):
        xk = rand(1, w[name]["q8"].shape[1])
        gt, wt = mv.gemv_stacked(xk, [w[name]["q8"]], 0)[0], mv.gemv_stacked_plain(xk, [w[name]["q8"]], 0)[0]
        assert (gt - wt).abs().max() <= 1e-4 * wt.abs().max()
    gu = mv.gemv_gateup(x, w["g"]["q8"], w["u"]["q8"], w["g"]["scale"], w["u"]["scale"], 1)
    gu_ref = mv.gemv_gateup_plain(x, w["g"]["q8"], w["u"]["q8"], w["g"]["scale"], w["u"]["scale"], 1)
    assert (gu - gu_ref).abs().max() <= 1e-4 * gu_ref.abs().max()
    head = sharding.shard_leaf(quantize_head(rand(d, vocab, scale=0.02)), (None, "tensor"), tensor - 1, tensor)
    assert head["q8"].shape == (d, vocab // tensor) and head["q8"].is_contiguous()
    gt = mv.matvec_q8(x, head["q8"], head["scale"])
    wt = mv.gemv_stacked_plain(x, [head["q8"][None]], 0)[0] * head["scale"]
    assert (gt - wt).abs().max() <= 1e-4 * wt.abs().max()

    pool_k, pool_v, qd = rand(4096, hk, 128), rand(4096, hk, 128), rand(hq, 128)
    gt, wt = da.ragged_decode_attn(qd, pool_k, pool_v, 3001), da.ragged_decode_attn_plain(qd, pool_k, pool_v, 3001)
    err = (gt.float() - wt.float()).abs().amax(-1) / wt.float().abs().amax(-1)
    assert err.max() <= 2e-2
