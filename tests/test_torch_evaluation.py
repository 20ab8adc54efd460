"""PyTorch port vs the JAX package: the offline accuracy harness and the
lmms-eval shim (``framefusion_tpu_torch.evaluation`` against
``framefusion_tpu.evaluation``).

One set of tiny fp32 weights (drawn once, carried to the port with
``params_from_numpy``) and the ``tests/test_engine.build_inputs`` prompts go
through JAX's ``run_offline_eval`` (einsum) and the port's (einsum): every
count, length, agreement and match is EQUAL, and the first-token KL agrees
to 1e-5 absolute (fp32 log-softmax over the same logits, which agree to
1e-4 through four layers summed in other orders; the KL is a difference of
near-equal terms, so it is held absolutely). The adapter tests mirror
``tests/test_evaluation.py``'s: the import gate, the recorded requests and
a mock lmms-eval driving a real model.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.evaluation.harness import run_offline_eval as jax_run_offline_eval
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.evaluation import LmmsEvalAdapter, run_offline_eval
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from test_engine import build_inputs

torch.set_num_threads(1)

KL_ATOL = 1e-5
KNOBS = (0.5, 0.7, 0.05)
SEEDS = ((0, 0.3), (1, 0.8), (2, 0.5))  # build_inputs (seed, coherent)


def shared_weights(cfg, seed: int = 0):
    """(JAX params, port params) of one set of weights: the port's
    ``init_params`` drawn on the CPU, read as numpy, carried to the port with
    ``params_from_numpy`` and to JAX as arrays (the same layout; no JAX
    program is compiled to draw them)."""
    tree = jax.tree.map(lambda t: t.numpy(), tq.init_params(cfg, torch.Generator().manual_seed(seed)))
    return jax.tree.map(jnp.asarray, tree), tq.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_tiny(num_layers=4), tiny_llm_config(num_layers=4)
    jp, tp = shared_weights(tcfg)
    jd = JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum")
    td = FrameFusionModel(family="llava_video", cfg=tcfg, params=tp, attn_impl="einsum")
    jf, tf = jax_apply(jd, *KNOBS), apply_framefusion(td, *KNOBS)
    jf.ff = jf.ff.replace(schedule_num_layers=4)
    tf.ff = tf.ff.replace(schedule_num_layers=4)
    return jd, jf, td, tf


def prompts(cls):
    out = []
    for seed, coherent in SEEDS:
        h, pt, pos, start, n = build_inputs(seed=seed, coherent=coherent)
        out.append(cls(input_embeds=h, patch_type=pt, position_ids=pos, patch_num=6, image_token_start=start,
                       image_token_length=n))
    return out


def test_offline_eval_matches_jax(models):
    jd, jf, td, tf = models
    want = jax_run_offline_eval(jd, jf, prompts(JaxInputs), max_new_tokens=6)
    got = run_offline_eval(td, tf, prompts(PrefillInputs), max_new_tokens=6)
    json.dumps(got, allow_nan=False)  # strict JSON end to end
    assert set(got) == set(want) and got["num_prompts"] == want["num_prompts"] == 3
    for key in ("mean_reduction", "mean_greedy_agreement", "first_token_match_rate"):
        assert got[key] == want[key], key
    assert abs(got["mean_kl_first_token"] - want["mean_kl_first_token"]) <= KL_ATOL
    assert 0.0 < got["mean_reduction"] <= 1.0
    for g, w in zip(got["per_prompt"], want["per_prompt"]):
        assert set(g) == set(w)
        for key in ("prompt_tokens", "final_tokens", "vision_token_reduction", "greedy_match_len",
                    "greedy_agreement", "top1_logit_match"):
            assert g[key] == w[key], key
        assert abs(g["kl_first_token"] - w["kl_first_token"]) <= KL_ATOL
    assert len({g["final_tokens"] for g in got["per_prompt"]}) > 1  # the prompts compress differently


def test_final_tokens_and_reduction_are_the_prefills(models):
    """Each prompt's final_tokens and reduction are its own FrameFusion
    prefill's telemetry; a tensor prompt on the logits' device gives the
    numpy prompt's report."""
    _, _, td, tf = models
    ps = prompts(PrefillInputs)
    got = run_offline_eval(td, tf, ps, max_new_tokens=3)
    for p, row in zip(ps, got["per_prompt"]):
        res = tf.prefill(p)
        assert row["final_tokens"] == res.valid_len
        assert row["vision_token_reduction"] == res.telemetry.vision_token_reduction
        assert row["prompt_tokens"] == p.input_embeds.shape[0]
    as_tensors = [PrefillInputs(torch.from_numpy(p.input_embeds), p.patch_type, p.position_ids, p.patch_num,
                                p.image_token_start, p.image_token_length) for p in ps]
    assert run_offline_eval(td, tf, as_tensors, max_new_tokens=3) == got


def test_lmms_adapter_gated():
    with pytest.raises(ImportError):
        LmmsEvalAdapter(None, None, None)


class FakeInstance:
    """lmms-eval's ``Instance`` as ``generate_until`` receives it: ``args`` =
    (context, gen_kwargs, doc_to_visual, doc_id, task, split)."""

    def __init__(self, context, gen_kwargs, doc_id):
        self.args = (context, gen_kwargs, lambda doc: [], doc_id, "videomme", "test")


def test_lmms_adapter_recorded_requests(monkeypatch):
    """The recorded requests of ``tests/test_evaluation.py`` through the
    port's adapter with a scripted model: the same strings byte for byte and
    the same (doc, budget, eos) calls (args parsing, per-request budgets,
    the default, eos forwarding, every shape of ``until``)."""
    monkeypatch.setitem(sys.modules, "lmms_eval", types.ModuleType("lmms_eval"))

    class ScriptedModel:
        def __init__(self):
            self.calls = []

        def generate(self, inputs, max_new, eos_token_id=None):
            self.calls.append((inputs, max_new, eos_token_id))
            return [100 * inputs + i for i in range(max_new)], None

    class Tok:
        eos_token_id = 7

        def decode(self, ids):
            return " ".join(f"t{i}" for i in ids)

    model = ScriptedModel()
    adapter = LmmsEvalAdapter(model, Tok(), lambda req: req.args[3], max_new_tokens=4)
    fixtures = [
        (FakeInstance("q0", {}, 0), "t0 t1 t2 t3"),
        (FakeInstance("q1", {"max_new_tokens": 2}, 1), "t100 t101"),
        (FakeInstance("q2", {"max_new_tokens": 4, "until": "t202"}, 2), "t200 t201 "),
        (FakeInstance("q3", {"max_new_tokens": 4, "until": ["t302"]}, 3), "t300 t301 "),
        (FakeInstance("q4", {"max_new_tokens": 4, "until": ["t403", "t401"]}, 4), "t400 "),
        (FakeInstance("q5", {"max_new_tokens": 3, "until": ["zzz"]}, 5), "t500 t501 t502"),
        (FakeInstance("q6", {"max_new_tokens": 2, "until": ["t600"]}, 6), ""),
        (FakeInstance("q7", {"max_new_tokens": 2, "until": None}, 7), "t700 t701"),
    ]
    assert adapter.generate_until([f for f, _ in fixtures]) == [want for _, want in fixtures]
    assert model.calls == [(0, 4, 7), (1, 2, 7), (2, 4, 7), (3, 4, 7), (4, 4, 7), (5, 3, 7), (6, 2, 7), (7, 2, 7)]


def test_lmms_adapter_against_mock_harness(monkeypatch, models):
    """A mock lmms-eval drives the port's adapter over a real model: the
    same strings as JAX's adapter over JAX's model on the same weights
    (budgets honoured, stop strings cut)."""
    from framefusion_tpu.evaluation.harness import LmmsEvalAdapter as JaxAdapter

    monkeypatch.setitem(sys.modules, "lmms_eval", types.ModuleType("lmms_eval"))
    _, jf, _, tf = models

    class Tok:
        eos_token_id = None

        def decode(self, ids):
            return " ".join(str(i) for i in ids)

    jp, tp = prompts(JaxInputs), prompts(PrefillInputs)
    port = LmmsEvalAdapter(tf, Tok(), lambda req: tp[req.args[3]], max_new_tokens=8)
    ref = JaxAdapter(jf, Tok(), lambda req: jp[req.args[3]], max_new_tokens=8)
    reqs = [FakeInstance("describe the video", {"max_new_tokens": 5}, 0), FakeInstance("what happens?", {}, 1)]
    outs = port.generate_until(reqs)
    assert outs == ref.generate_until(reqs)
    assert len(outs[0].split()) == 5 and len(outs[1].split()) == 8
    stop = outs[0].split()[-1]
    cut = port.generate_until([FakeInstance("describe the video", {"max_new_tokens": 5, "until": [stop]}, 0)])
    assert cut == [outs[0][:outs[0].find(stop)]]
