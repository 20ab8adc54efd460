"""PyTorch port vs the JAX package: the training step across ranks.

``framefusion_tpu_torch.parallel.train.make_train_step(..., mesh=)`` on 4
CPU ranks over ``gloo`` (``parallel/launch.spawn``) against JAX's
``make_train_step(cfg, mesh)`` on ``make_mesh(jax.devices()[:4],
tensor=t)`` (GSPMD over the virtual CPU devices of ``tests/conftest.py``),
from the same weights (JAX's ``init_params``, the qkv biases drawn nonzero)
and the same global batches (B 4, T 16, numpy ``default_rng``). Cases:
tensor 2 x data 2 (untied and tied head), tensor 4 (8 / 4 heads) and the
tiny Qwen2-MoE stack at tensor 2 x data 2 (the experts in the tensor slot,
as JAX's ``param_pspecs``). Held, with the one-card bounds of
``tests/test_torch_train.py``:

* each rank's gradient of each leaf after the first backward against its
  shard of ``jax.grad(lm_loss)`` within GRAD_RTOL of the leaf's largest
  gradient: a missing sum of a column-split input's gradient, a head cut
  from the graph or a partial router gradient fails it;
* the losses of 3 AdamW steps within LOGIT_RTOL and each rank's final
  parameters within STEP_PARAM_TOL of its shard of JAX's;
* every replicated leaf bitwise equal on every rank after the steps (and
  each split leaf on the ranks of the other data replica).

One spawn runs every case; JAX runs meanwhile in this process.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.config import tiny_moe_llm_config as jax_tiny_moe
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.parallel import sharding as jsharding
from framefusion_tpu.parallel import train as jt
from framefusion_tpu_torch.config import tiny_llm_config, tiny_moe_llm_config
from framefusion_tpu_torch.parallel import launch, sharding, train, workers

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="JAX's sharded steps need 4 devices")

WORLD, B, T, LR, STEPS = 4, 4, 16, 1e-3, 3
LOGIT_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_PARAM_TOL = 0.05 * STEPS * LR
CASES = {"tp2": (dict(), 2), "tied": (dict(tie_word_embeddings=True), 2),
         "tp4": (dict(num_heads=8, num_kv_heads=4), 4), "moe": ("moe", 2)}
ORDER = list(CASES)


def _configs(name):
    kw, tensor = CASES[name]
    if kw == "moe":
        return jax_tiny_moe(num_layers=2), tiny_moe_llm_config(num_layers=2), tensor
    return jax_tiny(num_layers=2, **kw), tiny_llm_config(num_layers=2, **kw), tensor


def _jax_params(jcfg, seed):
    p = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    for i, name in enumerate(("bq", "bk", "bv")):  # nonzero biases, so their gradients mean something
        p["layers"][name] = 0.1 * jax.random.normal(jax.random.PRNGKey(10 + i), p["layers"][name].shape)
    return p


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def _shard(tree, cfg, tensor_rank, width):
    torch_tree = train.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return train.tree_map(lambda t: t.numpy(), sharding.shard_params(torch_tree, cfg, sharding.ShardAxis("tensor", tensor_rank, width)))


def _jax_run(name, jp, batches):
    """JAX's gradient of the first batch (unsharded) and its sharded
    step's losses and final parameters."""
    jcfg, _, tensor = _configs(name)
    with Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor")):
        grads = _np(jax.grad(jt.lm_loss)(jp, jnp.asarray(batches[0]), jcfg))
    mesh = jsharding.make_mesh(jax.devices()[:4], tensor=tensor)
    step, init, batch_shard = jt.make_train_step(jcfg, mesh, jt.make_optimizer(LR))
    losses = []
    with mesh:
        p, s = init(jax.tree.map(jnp.copy, jp))
        for b in batches:
            p, s, loss = step(p, s, jax.device_put(jnp.asarray(b), batch_shard))
            losses.append(float(loss))
    return {"grads": grads, "losses": losses, "params": _np(p)}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(7)
    jobs, todo = [], {}
    for i, name in enumerate(ORDER):
        jcfg, tcfg, tensor = _configs(name)
        jp = _jax_params(jcfg, i)
        batches = [rng.integers(0, tcfg.vocab_size, (B, T)) for _ in range(STEPS)]
        jobs.append(dict(kind="train", cfg=tcfg, params=_np(jp), tensor=tensor, batches=batches, lr=LR))
        todo[name] = (jp, batches)
    probe = np.random.default_rng(8).standard_normal((B, T, 512)).astype(np.float32)
    jobs[0]["probe"] = probe
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, workers.run_jobs, WORLD, jobs, backend="gloo", device="cpu",
                            timeout_s=300)
        refs = {name: _jax_run(name, jp, batches) for name, (jp, batches) in todo.items()}
        jp, batches = todo[ORDER[0]]
        jcfg = _configs(ORDER[0])[0]
        with Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor")):
            refs["probe"] = _np(jax.grad(lambda p: (jt.forward_batched(p, jnp.asarray(batches[0]), jcfg)
                                                    * probe).sum())(jp))
        outs = ranks.result()
    return refs, outs


def _pairs(a, b, name=""):
    if isinstance(a, dict):
        return [p for k in a for p in _pairs(a[k], b[k], f"{name}/{k}")]
    return [(name, a, b)]


@pytest.mark.parametrize("name", ORDER)
def test_gradients_match_jax_grad(runs, name):
    refs, outs = runs
    j = ORDER.index(name)
    _, tcfg, tensor = _configs(name)
    for o in outs:
        want = _shard(refs[name]["grads"], tcfg, o[j]["place"]["tensor"], tensor)
        checked = _pairs(o[j]["grads"], want)
        assert len(checked) == len(train.leaves(o[j]["grads"]))
        for leaf, got, w in checked:
            err = np.abs(got - w).max() / np.abs(w).max()
            assert err <= GRAD_RTOL, (o[j]["place"], leaf, err)


@pytest.mark.parametrize("name", ORDER)
def test_three_adamw_steps_match_jax(runs, name):
    refs, outs = runs
    j = ORDER.index(name)
    _, tcfg, tensor = _configs(name)
    for o in outs:
        np.testing.assert_allclose(o[j]["losses"], refs[name]["losses"], rtol=LOGIT_RTOL)
        want = _shard(refs[name]["params"], tcfg, o[j]["place"]["tensor"], tensor)
        for leaf, got, w in _pairs(o[j]["params"], want):
            err = np.abs(got - w).max()
            assert err <= STEP_PARAM_TOL, (o[j]["place"], leaf, err)


@pytest.mark.parametrize("name", ORDER)
def test_replicated_leaves_are_bitwise_equal_on_every_rank(runs, name):
    """A leaf the tensor axis does not split is the same bits on all four
    ranks; a split leaf is on the two ranks of each tensor place."""
    _, outs = runs
    j = ORDER.index(name)
    _, tcfg, _ = _configs(name)
    flat_specs = workers.named_leaves(sharding.param_pspecs(tcfg))
    for what in ("params", "grads"):
        named = [workers.named_leaves(o[j][what]) for o in outs]
        replicated = [k for k, v in flat_specs.items() if "tensor" not in v]
        assert {"/final_norm", "/layers/ln1", "/layers/ln2"} <= set(replicated)
        for leaf in named[0]:
            same = [r for r in range(WORLD) if "tensor" not in flat_specs[leaf]
                    or outs[r][j]["place"]["tensor"] == outs[0][j]["place"]["tensor"]]
            for r in same:
                assert np.array_equal(named[r][leaf], named[0][leaf]), (what, leaf, r)


def test_gathered_logits_carry_their_gradient(runs):
    """``forward_batched`` under the mesh gathers the vocabulary slices
    (``collectives.vocab_gather``); the gradient of a weighted sum of the
    gathered logits reaches every leaf of every rank's shard as JAX's
    ``jax.grad`` of the unsharded forward gives it (the gather hands each
    rank its slice of the gradient back)."""
    refs, outs = runs
    _, tcfg, tensor = _configs(ORDER[0])
    for o in outs:
        want = _shard(refs["probe"], tcfg, o[0]["place"]["tensor"], tensor)
        for leaf, got, w in _pairs(o[0]["probe_grads"], want):
            err = np.abs(got - w).max() / np.abs(w).max()
            assert err <= GRAD_RTOL, (o[0]["place"], leaf, err)


def test_tied_head_gets_the_lookup_and_the_head_gradients(runs):
    """A tied head under tensor parallelism: each rank's vocabulary slice of
    the embedding takes the gradient of its lookups and of its slice of
    the logits in one leaf, as JAX's (held in test_gradients_match_jax_grad),
    and no rank holds a head."""
    refs, outs = runs
    j = ORDER.index("tied")
    for o in outs:
        assert "lm_head" not in o[j]["grads"]
        assert o[j]["grads"]["embed"].shape == (256, 128) and np.abs(o[j]["grads"]["embed"]).max() > 0
    assert "lm_head" not in refs["tied"]["grads"]


def test_moe_router_steps_as_one_process(runs):
    """The router (whole on every rank, its uses split with the experts):
    its gradient on every rank is JAX's whole gradient, not a rank's share,
    and every rank's router after the steps is the one-process step's."""
    refs, outs = runs
    j = ORDER.index("moe")
    want_g, want_p = refs["moe"]["grads"]["layers"]["router"], refs["moe"]["params"]["layers"]["router"]
    for o in outs:
        assert o[j]["params"]["layers"]["w_gate"].shape[1] == 2  # this rank's 2 of 4 experts
        for name in ("router", "shared_gate"):
            got = o[j]["grads"]["layers"][name]
            w = refs["moe"]["grads"]["layers"][name]
            assert np.abs(got - w).max() <= GRAD_RTOL * np.abs(w).max(), name
        assert np.abs(o[j]["grads"]["layers"]["router"] - want_g).max() <= GRAD_RTOL * np.abs(want_g).max()
        assert np.abs(o[j]["params"]["layers"]["router"] - want_p).max() <= STEP_PARAM_TOL


def test_data_rows_split_the_batch_and_refuse_a_remainder():
    ids = torch.arange(12).reshape(4, 3)
    assert torch.equal(sharding.ShardAxis("tensor", 0, 2, data_rank=1, data_width=2).rows(ids), ids[2:])
    with pytest.raises(ValueError, match="does not split over 2 data ranks"):
        sharding.ShardAxis("tensor", 0, 2, data_rank=0, data_width=2).rows(ids[:3])