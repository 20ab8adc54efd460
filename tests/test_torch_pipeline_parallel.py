"""PyTorch port vs the JAX package: the GPipe pipeline over a ``stage`` axis.

JAX's own cases (``tests/test_pipeline_parallel.py``: ``tiny_llm_config(
num_layers=8, vocab_size=256)``, ``init_params(PRNGKey(0))``, ids (8, 16)
from numpy ``default_rng(0)``) run through ``framefusion_tpu_torch.
parallel.pipeline`` on 4 CPU ranks over ``gloo`` and through JAX's
``pipeline`` on 4 of the virtual CPU devices of ``tests/conftest.py``:

* ``pipeline_forward`` at 4 stages / 4 microbatches and at 2 stages x 2
  data ranks / 2 microbatches against JAX's, within 2e-4 (JAX's bound
  against the unsharded forward);
* the refusals (a batch that does not split into the microbatches, layers
  that do not split over the stages) as ``ValueError``, where JAX asserts;
* ``make_pipe_train_step``: 3 AdamW steps (lr 1e-3) on one batch; the first
  loss within 1e-3 of the unsharded ``lm_loss`` (JAX's bound) and the loss
  falls; each rank's parameters after the steps against its stage of JAX's
  pipe step within the one-card bound (5% of the most 3 steps can move a
  parameter); the embedding, the final norm and the head bitwise equal on
  every rank, each layer leaf on both data replicas of its stage;
* the stage placement: each rank's layer shapes are JAX's shard shapes.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.parallel import pipeline as jpipe
from framefusion_tpu.parallel.train import forward_batched, lm_loss, make_optimizer
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.parallel import launch, pipeline, sharding, train, workers

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="JAX's pipelines need 4 devices")

WORLD, LR, STEPS = 4, 1e-3, 3
FWD_TOL = 2e-4  # JAX's bound (tests/test_pipeline_parallel.py)
LOSS_TOL = 1e-3  # JAX's bound on the first pipelined loss
STEP_PARAM_TOL = 0.05 * STEPS * LR
LAYOUTS = {"s4": (4, 1, 4), "s2d2": (2, 2, 2)}  # stages, data, microbatches


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def _jax_run(params, ids, cfg, stages, data, n_micro):
    mesh = jpipe.make_pipe_mesh(jax.devices()[:stages * data], stages=stages, data=data)
    with mesh:
        logits = np.asarray(jpipe.pipeline_forward(jpipe.shard_params_pipe(params, cfg, mesh), ids, cfg, mesh,
                                                   n_micro=n_micro))
    step, init, batch_shard = jpipe.make_pipe_train_step(cfg, mesh, n_micro=n_micro, optimizer=make_optimizer(LR))
    losses = []
    with mesh:
        p, s = init(jax.tree.map(jnp.copy, params))
        for _ in range(STEPS):
            p, s, loss = step(p, s, jax.device_put(ids, batch_shard))
            losses.append(float(loss))
    return {"logits": logits, "losses": losses, "params": _np(p)}


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = jax_tiny(num_layers=8, vocab_size=256), tiny_llm_config(num_layers=8, vocab_size=256)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    ids_np = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16))
    ids = jnp.asarray(ids_np, jnp.int32)
    tree = _np(jp)
    jobs = [dict(kind="pipe", cfg=cfg, params=tree, stages=s, n_micro=m, batches=[ids_np] * STEPS, lr=LR)
            for s, _, m in LAYOUTS.values()]
    jobs.append(dict(kind="refuse", cfg=cfg, params=tree, stages=4, ids=ids_np))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, workers.run_jobs, WORLD, jobs, backend="gloo", device="cpu",
                            timeout_s=300)
        with jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor")):
            ref = {"logits": np.asarray(forward_batched(jp, ids, jcfg)), "loss": float(lm_loss(jp, ids, jcfg))}
        refs = {name: _jax_run(jp, ids, jcfg, *layout) for name, layout in LAYOUTS.items()}
        outs = ranks.result()
    return cfg, jcfg, jp, ref, refs, outs


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipeline_forward_matches_jax(runs, name):
    _, _, _, ref, refs, outs = runs
    j = list(LAYOUTS).index(name)
    for o in outs:
        np.testing.assert_allclose(o[j]["logits"], refs[name]["logits"], atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(o[j]["logits"], ref["logits"], atol=FWD_TOL, rtol=FWD_TOL)


def test_refuses_what_jax_asserts(runs):
    outs = runs[-1]
    for o in outs:
        got = o[len(LAYOUTS)]
        assert "does not split into 2 microbatches" in got["batch"]
        assert "6 layers do not split over 4 stages" in got["layers"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipe_train_step_first_loss_and_falls(runs, name):
    _, _, _, ref, refs, outs = runs
    j = list(LAYOUTS).index(name)
    for o in outs:
        losses = o[j]["losses"]
        assert abs(losses[0] - ref["loss"]) < LOSS_TOL, (losses[0], ref["loss"])
        assert losses[-1] < losses[1] < losses[0]
        np.testing.assert_allclose(losses, refs[name]["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipe_params_after_steps_match_jax(runs, name):
    cfg, _, _, _, refs, outs = runs
    j = list(LAYOUTS).index(name)
    stages = LAYOUTS[name][0]
    per = cfg.num_layers // stages
    want = refs[name]["params"]
    for o in outs:
        s = o[j]["place"]["stage"]
        got = workers.named_leaves(o[j]["params"])
        for leaf, w in workers.named_leaves(want).items():
            if leaf.startswith("/layers/"):
                w = w[s * per:(s + 1) * per]
            err = np.abs(got[leaf] - w).max()
            assert got[leaf].shape == w.shape and err <= STEP_PARAM_TOL, (o[j]["place"], leaf, err)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_replicated_leaves_are_bitwise_equal_on_every_stage(runs, name):
    """The embedding, the final norm and the head (one logical array each,
    a copy on every stage) are the same bits on all four ranks after the
    steps; each layer leaf is on both data replicas of its stage."""
    outs = runs[-1]
    j = list(LAYOUTS).index(name)
    for what in ("params", "grads"):
        named = [workers.named_leaves(o[j][what]) for o in outs]
        for leaf in ("/embed", "/final_norm", "/lm_head"):
            assert all(np.array_equal(n[leaf], named[0][leaf]) for n in named), (what, leaf)
        for r, o in enumerate(outs):
            twin = next(q for q, p in enumerate(outs) if p[j]["place"]["stage"] == o[j]["place"]["stage"])
            assert all(np.array_equal(named[r][k], named[twin][k]) for k in named[r] if k.startswith("/layers/"))


def test_stage_placement_matches_jax_shards(runs):
    cfg, jcfg, jp, _, _, outs = runs
    mesh = jpipe.make_pipe_mesh(jax.devices()[:4], stages=4)
    sharded = jpipe.shard_params_pipe(jp, jcfg, mesh)
    want = {k: v.addressable_shards[0].data.shape for k, v in sharded["layers"].items()}
    assert want["wq"] == (2, cfg.hidden_size, cfg.num_heads * cfg.head_dim_)
    j = list(LAYOUTS).index("s4")
    for o in outs:
        assert {k: v.shape for k, v in o[j]["params"]["layers"].items()} == want
        assert o[j]["params"]["embed"].shape == (cfg.vocab_size, cfg.hidden_size)


@pytest.mark.parametrize("kw", [{}, {"tie_word_embeddings": True}, {"qkv_bias": False}],
                         ids=["untied", "tied", "no_bias"])
def test_pipe_param_pspecs_match_jax(kw):
    want = jax.tree.map(tuple, jpipe.pipe_param_pspecs(jax_tiny(**kw)),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert pipeline.pipe_param_pspecs(tiny_llm_config(**kw)) == want


def test_init_sharded_params_draws_a_stage_as_the_whole():
    """A stage's draw holds the whole draw's layers of that stage, bit for
    bit (each seeded by its global index), and whole copies of the rest;
    ``shard_params_pipe`` of the whole draw gives the same tree."""
    cfg = tiny_llm_config(num_layers=8, vocab_size=256)
    whole = sharding.init_sharded_params(cfg, 5, None, device="cpu")
    for s in range(4):
        part = sharding.init_sharded_params(cfg, 5, sharding.ShardAxis("stage", s, 4), device="cpu")
        cut = pipeline.shard_params_pipe(whole, cfg, sharding.ShardAxis("stage", s, 4))
        pairs = list(zip(train.leaves(part), train.leaves(cut)))
        assert len(pairs) == len(train.leaves(whole)) and all(torch.equal(a, b) for a, b in pairs)
        assert part["layers"]["wq"].shape[0] == 2
    with pytest.raises(ValueError, match="do not split over 3 stages"):
        sharding.ShardAxis("stage", 0, 3).layers(cfg)
    moe = tq.init_params(tiny_llm_config(num_layers=2), torch.Generator().manual_seed(0))
    moe["layers"]["router"] = torch.zeros(2, 128, 4)
    with pytest.raises(ValueError, match="no leaves"):
        pipeline.shard_params_pipe(moe, cfg, sharding.ShardAxis("stage", 0, 2))
