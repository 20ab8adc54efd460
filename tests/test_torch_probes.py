"""PyTorch port vs the JAX package: the trained-model probes.

``framefusion_tpu_torch.scripts.accuracy_probe`` / ``spec_probe`` against
the repository's ``scripts/accuracy_probe.py`` / ``scripts/spec_probe.py``
(loaded from their files; their ``main`` is not run). Both sides run the
tiny stack (``tiny_llm_config(vocab_size=64)``, fp32) on the plain fp32
path (``attn_impl="einsum"``), as both probes' engines do:

* the task generators give EQUAL arrays for both tasks and three seeds;
* ``train`` (20 steps of 8) from JAX's initial weights carried across:
  final losses within 1e-4 relative and every parameter within 5% of the
  most 20 AdamW steps can move it (20 * lr; see ``test_torch_train``:
  Adam turns rounding in a tiny gradient into a step of up to lr);
* on weights JAX trained (50 steps of 16, carried across with
  ``params_from_numpy``), every decision and count is EQUAL: dense and
  nudged accuracy, the cost sweep (accuracies, reductions, the infeasible
  marker), ``baseline_pareto``, ``s_th_ablation`` (merge / prune splits,
  infeasible markers), the greedy answers themselves, and
  ``spec_probe.run_config`` / ``serving_rows`` (acceptance, tokens a pass,
  macro steps, chunk counts, agreement) on echo-trained weights; only the
  time columns, the reading notes (the port's ``reading_note`` depends
  on the task) and the port's own count of prefills that removed every
  image token differ;
* each probe's ``main`` at a tiny size on the CPU writes strict JSON
  (``allow_nan=False``) with every key of the JAX record, and exits
  non-zero without a card unless asked for the CPU; the accuracy probe's
  ``--weights`` evaluates an .npz of JAX-trained weights.

Run as a script, this file trains JAX's probe stack at the JAX script's
full size on the CPU and writes its weights and JAX's own record on them,
for the port's ``accuracy_probe --weights`` (see the end of the file).
"""

import ast
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.core.similarity import similarity_by_patch as jax_similarity_by_patch
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.core.schedule import CostInfeasibleError as JaxInfeasible
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.baselines import qwen2_baselines
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.runtime import engine as engine_mod
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.scripts import accuracy_probe as ap
from framefusion_tpu_torch.scripts import spec_probe as sp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
LR = 1e-3
TIME_KEYS = {"plain_decode_wall_ms", "spec_decode_wall_ms", "wall_speedup", "plain_wall_ms", "spec_wall_ms",
             "plain_tokens_per_s", "spec_tokens_per_s", "serving_wall_speedup"}
NOTE_KEYS = {"reading_note", "normalized_cost_note"}
EMPTIED_KEYS = {"all_image_tokens_removed"}  # the port's count; JAX's records have no such key


def _load_jax_scripts():
    """The JAX probes as modules (``spec_probe`` imports ``accuracy_probe``
    by that name, and both import the scripts' ``common``)."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        mods = {}
        for name in ("accuracy_probe", "spec_probe"):
            spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            sys.modules[name] = mods[name]
            spec.loader.exec_module(mods[name])
        return mods["accuracy_probe"], mods["spec_probe"]
    finally:
        sys.path.remove(str(SCRIPTS))


jap, jsp = _load_jax_scripts()
JCFG, CFG = jax_tiny(vocab_size=ap.VOCAB), tiny_llm_config(vocab_size=ap.VOCAB)


def strip(tree, drop):
    if isinstance(tree, dict):
        return {k: strip(v, drop) for k, v in tree.items() if k not in drop}
    if isinstance(tree, list):
        return [strip(v, drop) for v in tree]
    return tree


def to_port(params):
    return tq.params_from_numpy(jax.device_get(params), device="cpu")


def _jax_similarity_by_patch(hidden, patch_type, order, n_img):
    """JAX's ``similarity_by_patch`` on the port's tensors."""
    out = jax_similarity_by_patch(jnp.asarray(hidden.detach().float().cpu().numpy()),
                                  jnp.asarray(patch_type.cpu().numpy().astype(np.int32)),
                                  jnp.asarray(order.cpu().numpy().astype(np.int32)), jnp.int32(int(n_img)))
    return torch.from_numpy(np.array(out)).to(hidden.device)


@pytest.fixture
def jax_similarity(monkeypatch):
    """The port's engines take JAX's similarity values (JAX's function on the
    port's own hidden states). The probes' fillers repeat token ids, so
    bitwise-identical rows meet at the layer -1 merge: their cosine is 1 in
    exact arithmetic, but each package's fp32 sums round it to 1 give or
    take a few ulps, each in its own way, and the stable ranking then picks
    other tokens among the tied pairs (ROADMAP Queue 3; see
    ``test_identical_rows_round_apart``). With JAX's values every decision
    must be JAX's."""
    monkeypatch.setattr(engine_mod, "similarity_by_patch", _jax_similarity_by_patch)
    monkeypatch.setattr(qwen2_baselines, "similarity_by_patch", _jax_similarity_by_patch)


@pytest.fixture(scope="module")
def recall_params():
    """Weights JAX trained on the recall task (50 steps of 16), both sides."""
    jp, _ = jap.train(JCFG, 50, 16, LR, log_every=0)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def echo_params():
    """Weights JAX trained on the echo task (JAX's spec_probe main patches
    ``make_batch`` the same way), both sides."""
    saved = jap.make_batch
    jap.make_batch = lambda rng, batch, task="recall": np.stack([jsp.make_echo_instance(rng)[0] for _ in range(batch)])
    try:
        jp, _ = jap.train(JCFG, 50, 16, LR, log_every=0)
    finally:
        jap.make_batch = saved
    return jp, to_port(jp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_task_generators_equal_jax(seed):
    for task in ("recall", "transitions"):
        for a, b in zip(ap.make_instance(np.random.default_rng(seed), task),
                        jap.make_instance(np.random.default_rng(seed), task)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ap.make_batch(np.random.default_rng(seed), 5, task),
                                      jap.make_batch(np.random.default_rng(seed), 5, task))
    for a, b in zip(sp.make_echo_instance(np.random.default_rng(seed)),
                    jsp.make_echo_instance(np.random.default_rng(seed))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sp.echo_batch(np.random.default_rng(seed), 3),
                                  np.stack([jsp.make_echo_instance(r)[0] for r in [np.random.default_rng(seed)]
                                            for _ in range(3)]))
    ids, q, _ = ap.make_instance(np.random.default_rng(seed), "transitions")
    assert q == -1 and ids[-2] == ap.TRANS_QUERY  # the sentinel the docstring documents
    for a, b in zip(ap.build_prompt(ids), jap.build_prompt(ids)):
        np.testing.assert_array_equal(a, b)


def test_train_matches_jax(monkeypatch):
    steps = 20
    j_params, j_loss = jap.train(JCFG, steps, 8, LR, log_every=0)
    init = to_port(jq.init_params(JCFG, jax.random.PRNGKey(0)))  # JAX's train draws these from its seed
    monkeypatch.setattr(tq, "init_params", lambda *a, **k: init)
    curve = []
    t_params, t_loss = ap.train(CFG, steps, 8, LR, log_every=0, device="cpu", losses=curve)
    assert len(curve) == steps and curve[-1] == t_loss and curve[-1] < curve[0]
    assert abs(t_loss - j_loss) <= 1e-4 * abs(j_loss)
    want = to_port(j_params)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), t_params)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want))):
        assert np.abs(a - b).max() <= 0.05 * steps * LR


def test_accuracy_probe_decisions_equal_jax(recall_params, jax_similarity):
    jp, tp = recall_params
    rng = np.random.default_rng(1234)
    inst = [ap.make_instance(rng) for _ in range(6)]
    j_dense = JaxEngine(jp, JCFG, JaxFF(), attn_impl="einsum")
    t_dense = CompressionEngine(tp, CFG, FrameFusionConfig(), attn_impl="einsum")
    for nudge in (False, True):
        assert ap.evaluate(t_dense, tp, CFG, inst, compressed=False, nudge=nudge) == \
            jap.evaluate(j_dense, jp, JCFG, inst, compressed=False, nudge=nudge)
    # the greedy answers themselves, dense and at cost 0.5
    ff = dict(cost=0.5, similarity_lower_bound=0.6, ratio_lower_bound=0.05, schedule_num_layers=CFG.num_layers)
    j_ff = JaxEngine(jp, JCFG, JaxFF(**ff), attn_impl="einsum")
    t_ff = CompressionEngine(tp, CFG, FrameFusionConfig(**ff), attn_impl="einsum")
    for ids, _, _ in inst:
        prompt, pt, pos = ap.build_prompt(ids)
        h_t, h_j = ap.embed_prompt(tp, prompt), jq.embed(jp, jnp.asarray(prompt), JCFG)
        assert t_dense.generate_greedy(t_dense.dense_prefill(h_t, pos), 1) == \
            list(j_dense.generate_greedy(j_dense.dense_prefill(h_j, pos), 1))
        args = (pt, pos, ap.PATCH_NUM, 1, ap.N_FRAMES * ap.PATCH_NUM)
        assert t_ff.generate_greedy(t_ff.prefill(h_t, *args), 1) == \
            list(j_ff.generate_greedy(j_ff.prefill(h_j, *args), 1))

    sweep = ap.cost_sweep(tp, CFG, inst)
    j_sweep = []
    for cost in (0.9, 0.7, 0.5, 0.3, 0.2):  # the JAX main's sweep, inline there
        f = JaxFF(cost=cost, similarity_lower_bound=0.6, ratio_lower_bound=0.05, schedule_num_layers=JCFG.num_layers)
        try:
            acc, red = jap.evaluate(JaxEngine(jp, JCFG, f, attn_impl="einsum"), jp, JCFG, inst, compressed=True)
        except JaxInfeasible:
            j_sweep.append({"cost": cost, "infeasible": True})
            break
        j_sweep.append({"cost": cost, "accuracy": round(acc, 3), "token_reduction": round(red, 3)})
    assert strip(sweep, EMPTIED_KEYS) == j_sweep
    pareto = ap.baseline_pareto(tp, CFG, inst, sweep)
    assert strip(pareto, NOTE_KEYS | EMPTIED_KEYS) == strip(jap.baseline_pareto(jp, JCFG, inst, j_sweep), NOTE_KEYS)
    assert "needle recall" in pareto["reading_note"]
    assert "no single token" in ap.baseline_pareto(tp, CFG, inst[:1], sweep, task="transitions")["reading_note"]
    s_th = ap.s_th_ablation(tp, CFG, inst)
    assert strip(s_th, NOTE_KEYS | EMPTIED_KEYS) == strip(jap.s_th_ablation(jp, JCFG, inst), NOTE_KEYS)
    assert {r["s_th"] for r in s_th["rows"]} == {0.0, 0.5, 0.6, 0.7, 0.8, 0.9, 1.01}


def test_spec_probe_counts_equal_jax(echo_params, jax_similarity):
    jp, tp = echo_params
    rng = np.random.default_rng(4321)
    inst = [sp.make_echo_instance(rng) for _ in range(3)]
    ff = dict(cost=0.8, similarity_lower_bound=0.6, ratio_lower_bound=0.05, schedule_num_layers=CFG.num_layers)
    engines = {"dense": (JaxEngine(jp, JCFG, JaxFF(), attn_impl="einsum"),
                         CompressionEngine(tp, CFG, FrameFusionConfig(), attn_impl="einsum")),
               "framefusion": (JaxEngine(jp, JCFG, JaxFF(**ff), attn_impl="einsum"),
                               CompressionEngine(tp, CFG, FrameFusionConfig(**ff), attn_impl="einsum"))}
    for name, compressed, batched in (("dense", False, False), ("framefusion", True, True)):
        j_eng, t_eng = engines[name]
        kw = dict(compressed=compressed, draft_len=4, batched=batched)
        row = sp.run_config(t_eng, tp, CFG, inst, **kw)
        assert row["greedy_match"] and row["plain_decode_steps"] == len(inst) * 9
        assert strip(row, TIME_KEYS) == strip(jsp.run_config(j_eng, jp, JCFG, inst, **kw), TIME_KEYS)
        for full, _, _ in inst:  # the decoded answers themselves
            res_t, prompt = sp._prefill_one(t_eng, tp, CFG, full, compressed=compressed)
            res_j, _ = jsp._prefill_one(j_eng, jp, JCFG, full, compressed=compressed)
            assert t_eng.generate_greedy(res_t, 10) == list(j_eng.generate_greedy(res_j, 10))
    for name, mode in (("dense", "dense"), ("framefusion", "fused")):
        j_eng, t_eng = engines[name]
        row = sp.serving_rows(t_eng, tp, CFG, inst, 4, prefill_mode=mode)
        assert row["agreement"] == f"{len(inst) * 10}/{len(inst) * 10}"
        assert strip(row, TIME_KEYS) == strip(jsp.serving_rows(j_eng, jp, JCFG, inst, 4, prefill_mode=mode),
                                              TIME_KEYS)


def test_identical_rows_round_apart(recall_params):
    """The fault ``jax_similarity`` works around: both packages score a pair
    of bitwise-identical rows within a few fp32 ulps of 1, not at 1, and
    each rounds its own way; every other pair agrees to fp32 rounding."""
    from framefusion_tpu_torch.core import order_by_patch, similarity_by_patch

    _, tp = recall_params
    prompt, pt, _ = ap.build_prompt(ap.make_instance(np.random.default_rng(1234))[0])
    h = ap.embed_prompt(tp, prompt)
    order, n_img = order_by_patch(torch.from_numpy(pt).long(), torch.ones(len(pt), dtype=torch.bool), ap.PATCH_NUM)
    ours = similarity_by_patch(h, torch.from_numpy(pt).long(), order, n_img).numpy()
    theirs = np.asarray(jax_similarity_by_patch(jnp.asarray(h.numpy()), jnp.asarray(pt), jnp.asarray(order.numpy()),
                                                jnp.int32(int(n_img))))
    hp = h[order].numpy()
    same = np.concatenate([[False], (hp[1:] == hp[:-1]).all(-1)]) & (ours > -2)
    assert same.sum() >= 10
    ulp = 2.0 ** -23
    assert np.abs(ours[same] - 1).max() <= 8 * ulp and np.abs(theirs[same] - 1).max() <= 8 * ulp
    other = (ours > -2) & ~same
    assert np.abs(ours[other] - theirs[other]).max() <= 1e-6


def jax_record_keys(script: str) -> set:
    """The keys the JAX script's ``main`` writes into its record."""
    tree = ast.parse((SCRIPTS / f"{script}.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "record" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "record" \
                and isinstance(node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def _strict(path):
    def refuse(name):
        raise ValueError(f"not strict JSON: {name}")

    return json.loads(Path(path).read_text(), parse_constant=refuse)


def test_accuracy_probe_main_writes_strict_json(tmp_path):
    out = tmp_path / "acc.json"
    rec = ap.main(["--steps", "4", "--batch", "4", "--eval", "2", "--device", "cpu", "--no-baselines",
                   "--task", "transitions", "--json", str(out)])
    assert _strict(out) == rec
    assert jax_record_keys("accuracy_probe") <= set(rec) and rec["device"] == "CPU"
    assert rec["pareto"] is None and len(rec["s_th_sweep"]["rows"]) == 7 and "COUNT" in rec["task"]


def test_spec_probe_main_writes_strict_json(tmp_path):
    out = tmp_path / "spec.json"
    rec = sp.main(["--steps", "3", "--batch", "4", "--eval", "2", "--device", "cpu", "--json", str(out)])
    assert _strict(out) == rec
    keys = {"dense_solo", "dense_batched", "framefusion_solo", "framefusion_batched", "framefusion_gentle_solo",
            "dense_serving", "framefusion_serving", "framefusion_gentle_serving"}
    assert (jax_record_keys("spec_probe") | keys) <= set(rec) and rec["backend"] == "CPU"
    assert all(rec[k]["greedy_match"] for k in keys if "serving" not in k)


@pytest.mark.parametrize("probe", [ap, sp], ids=["accuracy_probe", "spec_probe"])
def test_probe_needs_the_card_unless_asked(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(SystemExit) as exc:
        probe.main(["--steps", "1", "--eval", "1"])
    assert exc.value.code not in (0, None)


def save_jax_weights(params, path) -> None:
    """JAX's params as the .npz the port's ``accuracy_probe --weights``
    reads: one array a leaf, keys joined by "/"."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            walk(v, f"{prefix}{k}/") if isinstance(v, dict) else flat.__setitem__(prefix + k, np.asarray(v))

    walk(jax.device_get(params), "")
    np.savez(path, **flat)


def test_accuracy_probe_evaluates_saved_weights(recall_params, jax_similarity, tmp_path):
    """``--weights`` evaluates weights JAX trained: the record's accuracies
    and sweep are JAX's on the same instances."""
    jp, _ = recall_params
    path = tmp_path / "w.npz"
    save_jax_weights(jp, path)
    rec = ap.main(["--weights", str(path), "--eval", "4", "--device", "cpu", "--no-baselines", "--no-s-th-sweep"])
    rng = np.random.default_rng(1234)
    inst = [jap.make_instance(rng) for _ in range(4)]
    dense = JaxEngine(jp, JCFG, JaxFF(), attn_impl="einsum")
    assert rec["dense_accuracy"] == round(jap.evaluate(dense, jp, JCFG, inst, compressed=False)[0], 3)
    assert rec["weights"] == str(path) and rec["train_steps"] == 0 and rec["final_loss"] is None
    assert rec["sweep"] == ap.cost_sweep(to_port(jp), CFG, inst)
    assert all(0 <= r["all_image_tokens_removed"] <= 4 for r in rec["sweep"] if "accuracy" in r)
    reds: list = []
    t_ff = CompressionEngine(to_port(jp), CFG, FrameFusionConfig(cost=0.5, schedule_num_layers=CFG.num_layers),
                                attn_impl="einsum")
    _, mean = ap.evaluate(t_ff, to_port(jp), CFG, inst, compressed=True, per_instance=reds)
    assert len(reds) == 4 and mean == pytest.approx(np.mean(reds)) and ap.all_removed(reds + [1.0]) >= 1


if __name__ == "__main__":
    # The probe's curve on equal weights, on the CPU (~13 min a task):
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_probes.py OUT [--tasks recall transitions]
    # trains JAX's probe stack (the JAX script's own ``train`` at its
    # defaults: 3,000 steps of 64, lr 1e-3, seed 0) for each task and writes
    # OUT/jax_{task}.npz, the weights for the port's
    #   python -m framefusion_tpu_torch.scripts.accuracy_probe --task TASK --weights OUT/jax_TASK.npz
    # OUT/jax_{task}.json, the JAX probe's own record on those weights, and
    # the port's records on them on the CPU, with its own similarity
    # (OUT/port_cpu_{task}.json) and with JAX's (OUT/port_cpu_jaxsim_{task}.json),
    # which parts the exact-tie fault (ROADMAP Queue 3) from the rest.
    import argparse

    cli = argparse.ArgumentParser()
    cli.add_argument("out")
    cli.add_argument("--tasks", nargs="+", default=["recall", "transitions"], choices=["recall", "transitions"])
    opts = cli.parse_args()
    out = Path(opts.out)
    out.mkdir(parents=True, exist_ok=True)
    jax_train = jap.train
    for task in opts.tasks:
        trained = jax_train(JCFG, 3000, 64, LR, task=task)
        save_jax_weights(trained[0], out / f"jax_{task}.npz")
        jap.train = lambda *a, trained=trained, **k: trained
        sys.argv = ["accuracy_probe", "--task", task, "--json", str(out / f"jax_{task}.json")]
        jap.main()
        args = ["--weights", str(out / f"jax_{task}.npz"), "--task", task, "--device", "cpu"]
        ap.main(args + ["--json", str(out / f"port_cpu_{task}.json")])
        saved = engine_mod.similarity_by_patch, qwen2_baselines.similarity_by_patch
        engine_mod.similarity_by_patch = qwen2_baselines.similarity_by_patch = _jax_similarity_by_patch
        try:
            ap.main(args + ["--json", str(out / f"port_cpu_jaxsim_{task}.json")])
        finally:
            engine_mod.similarity_by_patch, qwen2_baselines.similarity_by_patch = saved
