"""PyTorch port vs the JAX package: the one-card training step.

``framefusion_tpu_torch.parallel.train`` against ``framefusion_tpu.parallel.train``
on ``tiny_llm_config(num_layers=2)`` in fp32, tied and untied head, with
the qkv bias (drawn nonzero), at B 2 and T 24; ids from numpy
``default_rng``, JAX's weights carried across with ``params_from_numpy``.
JAX's step runs on a 1 x 1 CPU mesh, as ``scripts/accuracy_probe.py``
builds it. Tolerances:

* logits and loss: 1e-5 of the largest |logit| / of the loss (fp32 sums in
  another order; observed ~6e-7);
* each leaf's gradient: 1e-4 of that leaf's largest |gradient| (observed
  ~1e-6);
* three AdamW steps (lr 1e-3): losses within 1e-5 relative; each final
  parameter within 5% of the most the three steps can move it (3 * lr):
  Adam divides each gradient by its own running RMS, so an element whose
  gradient is tiny moves by up to lr a step in a direction set by rounding
  (observed 2.1e-5, 0.7% of 3 * lr);
* the rematerialised forward against the plain one: the same gradients,
  bitwise (the recomputation repeats the same CPU ops);
* the tiny Qwen2-MoE stack under the same bounds (its routing and
  capacity as JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.config import tiny_moe_llm_config as jax_tiny_moe
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.parallel import train as jt
from framefusion_tpu_torch.config import qwen2_7b_config, tiny_llm_config, tiny_moe_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.ops.quant import quantize_params_int8
from framefusion_tpu_torch.parallel import train as tt

torch.set_num_threads(1)

B, T, LR, STEPS = 2, 24, 1e-3, 3
LOGIT_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_PARAM_TOL = 0.05 * STEPS * LR


def jax_params(tied: bool):
    cfg = jax_tiny(num_layers=2, tie_word_embeddings=tied)
    p = jq.init_params(cfg, jax.random.PRNGKey(0))
    for i, name in enumerate(("bq", "bk", "bv")):  # nonzero biases, so their gradients mean something
        p["layers"][name] = 0.1 * jax.random.normal(jax.random.PRNGKey(10 + i), p["layers"][name].shape)
    return cfg, p


def trainable(tree):
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def pairs(a, b, name=""):
    """(path, port tensor, JAX array) for every leaf of two params trees."""
    if isinstance(a, dict):
        return [p for k in a for p in pairs(a[k], b[k], f"{name}/{k}")]
    return [(name, a, np.asarray(b))]


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def case(request):
    """JAX's logits, loss and gradients on one batch, and the port's params."""
    jcfg, jp = jax_params(request.param)
    cfg = tiny_llm_config(num_layers=2, tie_word_embeddings=request.param)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    with Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor")):
        logits = np.asarray(jt.forward_batched(jp, jnp.asarray(ids), jcfg))
        loss, grads = jax.value_and_grad(jt.lm_loss)(jp, jnp.asarray(ids), jcfg)
    return dict(cfg=cfg, ids=torch.from_numpy(ids), logits=logits, loss=float(loss), grads=jax.device_get(grads),
                params=jax.device_get(jp))


def test_forward_and_loss_match_jax(case):
    params = tq.params_from_numpy(case["params"], device="cpu")
    logits = tt.forward_batched(params, case["ids"], case["cfg"])
    assert logits.dtype == torch.float32 and logits.shape == (B, T, case["cfg"].vocab_size)
    err = np.abs(logits.detach().numpy() - case["logits"]).max() / np.abs(case["logits"]).max()
    assert err <= LOGIT_RTOL, err
    loss = float(tt.lm_loss(params, case["ids"], case["cfg"]))
    assert abs(loss - case["loss"]) <= LOGIT_RTOL * abs(case["loss"])


def test_gradients_match_jax(case):
    params = trainable(tq.params_from_numpy(case["params"], device="cpu"))
    tt.lm_loss(params, case["ids"], case["cfg"]).backward()
    checked = pairs(params, case["grads"])
    assert len(checked) == len(tt.leaves(params))
    for name, p, want in checked:
        err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL, (name, err)
    if case["cfg"].tie_word_embeddings:  # the gather's and the head's gradients summed into one leaf
        assert "lm_head" not in params and np.abs(params["embed"].grad.numpy()).max() > 0


def test_remat_gives_the_plain_gradients(case, monkeypatch):
    grads = []
    for plain in (False, True):
        if plain:  # every activation kept instead of recomputed
            monkeypatch.setattr(tt, "checkpoint", lambda f, *a, **k: f(*a))
        params = trainable(tq.params_from_numpy(case["params"], device="cpu"))
        tt.lm_loss(params, case["ids"], case["cfg"]).backward()
        grads.append([t.grad for t in tt.leaves(params)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_three_adamw_steps_match_jax(tied):
    jcfg, jp = jax_params(tied)
    cfg = tiny_llm_config(num_layers=2, tie_word_embeddings=tied)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(STEPS)]
    params = tq.params_from_numpy(jax.device_get(jp), device="cpu")

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor"))
    step, init, _ = jt.make_train_step(jcfg, mesh, jt.make_optimizer(LR))
    with mesh:
        jp, js = init(jp)
        j_losses = []
        for b in batches:
            jp, js, loss = step(jp, js, jnp.asarray(b))
            j_losses.append(float(loss))

    t_step, t_init = tt.make_train_step(cfg, device="cpu", optimizer=tt.make_optimizer(LR))
    params, opt = t_init(params)
    t_losses = []
    for b in batches:
        params, opt, loss = t_step(params, opt, b)
        assert loss.device.type == "cpu" and not loss.requires_grad
        t_losses.append(float(loss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOGIT_RTOL)
    for name, p, want in pairs(params, jax.device_get(jp)):
        err = np.abs(p.detach().numpy() - want).max()
        assert err <= STEP_PARAM_TOL, (name, err)


def test_optimizer_is_optax_adamw():
    leaves = [torch.zeros(3, requires_grad=True), torch.ones(2, requires_grad=True)]
    opt = tt.make_optimizer(3e-4)(leaves)
    assert isinstance(opt, torch.optim.AdamW) and len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert group["params"] == leaves and group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0.01
    assert tt.make_optimizer().keywords["lr"] == 1e-4  # JAX's default


def test_init_makes_every_leaf_trainable():
    cfg = tiny_llm_config(num_layers=2)
    _, init = tt.make_train_step(cfg, device="cpu")
    params, opt = init(tq.init_params(cfg, torch.Generator().manual_seed(0)))
    leaves = tt.leaves(params)
    assert all(t.is_leaf and t.requires_grad for t in leaves)
    assert {id(t) for t in opt.param_groups[0]["params"]} == {id(t) for t in leaves}  # norms and biases too


def test_refuses_int8_moe_and_no_card():
    """int8 pairs and, without a card, the default device are refused (a
    MoE stack now trains: ``test_moe_step_matches_jax``)."""
    cfg = tiny_llm_config(num_layers=2)
    _, init = tt.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        init(quantize_params_int8(tq.init_params(cfg, torch.Generator().manual_seed(0))))
    if not torch.cuda.is_available():  # the card by default: no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.make_train_step(cfg)


def test_moe_step_matches_jax():
    """The tiny Qwen2-MoE stack (4 experts, top-2, a shared expert; each
    sequence routed on its own at the capacity of its T, as JAX's vmapped
    ``layer_mlp``): the first step's gradients, the router's among them,
    within GRAD_RTOL of ``jax.grad(lm_loss)``; three AdamW steps' losses
    and parameters within the dense step's bounds."""
    jcfg = jax_tiny_moe(num_layers=2)
    cfg = tiny_moe_llm_config(num_layers=2)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(STEPS)]
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "tensor"))
    with mesh:
        grads = jax.device_get(jax.grad(jt.lm_loss)(jp, jnp.asarray(batches[0]), jcfg))
    step, init, _ = jt.make_train_step(jcfg, mesh, jt.make_optimizer(LR))
    start = jax.device_get(jp)
    with mesh:
        jp, js = init(jp)
        j_losses = []
        for b in batches:
            jp, js, loss = step(jp, js, jnp.asarray(b))
            j_losses.append(float(loss))

    t_step, t_init = tt.make_train_step(cfg, device="cpu", optimizer=tt.make_optimizer(LR))
    params, opt = t_init(tq.params_from_numpy(start, device="cpu"))
    t_losses = []
    for i, b in enumerate(batches):
        params, opt, loss = t_step(params, opt, b)
        t_losses.append(float(loss))
        if i == 0:
            for name, p, want in pairs(params, grads):
                err = np.abs(p.grad.numpy() - want).max() / np.abs(want).max()
                assert err <= GRAD_RTOL, (name, err)
    assert np.abs(params["layers"]["router"].grad.numpy()).max() > 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOGIT_RTOL)
    for name, p, want in pairs(params, jax.device_get(jp)):
        err = np.abs(p.detach().numpy() - want).max()
        assert err <= STEP_PARAM_TOL, (name, err)


def test_step_gemm_flops_hand_count():
    cfg = qwen2_7b_config(num_layers=4)
    per_layer = 3584 * 4608 + 3584 * 3584 + 3 * 3584 * 18944
    assert per_layer == 233_046_016
    head = 3584 * 152064
    want = 2 * 4096 * (4 * 4 * per_layer + 3 * head)
    assert tt.step_gemm_flops(cfg, 4096) == want
    assert 43.8e12 < want < 44.0e12
