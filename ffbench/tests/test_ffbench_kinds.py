"""A configuration kind brings its own decoder to the check and its own counters to the readers.

``stub_dense`` is a kind made only of modules of its own, defined here and
put in place under ``ffbench.families`` and ``ffbench.reference`` for the
test: LLaVA-Video's tower and prompt over a dense decoder whose every
(leaf, layer) is drawn from a stream of its own (``weights.Draws(...,
key=(leaf, layer))``). The program stacks and quantizes those draws as the
port's set-up does; the reference draws, rounds and frees one layer at a
time as its layer-major pass over the sample reaches it. The family's ``counters`` hook reads
the port's own ``preprocess.path_counts``.

For the kinds without a decoder of their own (``llava_video``,
``internvl``), the readings equal those of the check as it stood before
the seam (``before_seam``, a verbatim copy of the old ``check.readings``
and ``common.Decoder``) on the same sample, bit for bit.
"""

import json
import sys
import types
import weakref

import pytest
import torch

from ffbench import check, reference, run, weights
from ffbench.families import llava_video as llava_family
from ffbench.families.common import Program, apply_knobs, llm_config, torch_dtype
from ffbench.reference import common
from ffbench.reference import llava_video as llava_reference
from ffbench.tests import before_seam, tiny

SEED = 2**31 + 2626
KIND = "stub_dense"
WORKLOAD = "stub.qa"
NORMS = ("ln1", "ln2", "final_norm")


def _shapes(text: dict) -> dict:
    dm, i, hq, hk = text["hidden_size"], text["intermediate_size"], text["num_attention_heads"], \
        text["num_key_value_heads"]
    hd = text.get("head_dim") or dm // hq
    return {"ln1": (dm,), "ln2": (dm,), "wq": (dm, hq * hd), "wk": (dm, hk * hd), "wv": (dm, hk * hd),
            "wo": (hq * hd, dm), "w_gate": (dm, i), "w_up": (dm, i), "w_down": (i, dm),
            "bq": (hq * hd,), "bk": (hk * hd,), "bv": (hk * hd,)}


def _draw(config: dict, seed: int, leaf: str, layer: int, device) -> torch.Tensor:
    """One (leaf, layer) of the stub's decoder from its own stream; the
    model-wide leaves (embed, final_norm, lm_head) at layer -1."""
    text = config["text"]
    d = weights.Draws(seed, 0, device, torch_dtype(config), text.get("init_std", weights.STD), key=(leaf, layer))
    shape = {"embed": (text["vocab_size"], text["hidden_size"]), "final_norm": (text["hidden_size"],),
             "lm_head": (text["hidden_size"], text["vocab_size"])}.get(leaf) or _shapes(text)[leaf]
    return d.normal(*shape, std=0.05, mean=1.0) if leaf in NORMS else d.normal(*shape)


def _build(config: dict, seed: int, device) -> Program:
    """The port's served path with the stub's decoder: every layer's leaves
    stacked, the matrices quantized by the port's own set-up."""
    from framefusion_tpu_torch.interface import FrameFusionModel
    from framefusion_tpu_torch.models.vision import siglip
    from framefusion_tpu_torch.ops.quant import QUANTIZED_LAYER_WEIGHTS, quantize_weight
    from framefusion_tpu_torch.pipeline import TextPipeline

    from ffbench.generator import StubTokenizer

    dtype, v, text = torch_dtype(config), config["vision"], config["text"]
    layers = {}
    for leaf in _shapes(text):
        stack = torch.stack([_draw(config, seed, leaf, l, device) for l in range(text["num_hidden_layers"])])
        layers[leaf] = quantize_weight(stack) if leaf in QUANTIZED_LAYER_WEIGHTS else stack
    params = {"embed": _draw(config, seed, "embed", -1, device), "layers": layers,
              "final_norm": _draw(config, seed, "final_norm", -1, device),
              "lm_head": _draw(config, seed, "lm_head", -1, device)}
    vcfg = siglip.ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"], hidden_size=v["hidden_size"],
                            intermediate_size=v["intermediate_size"], num_layers=v["num_hidden_layers"],
                            num_heads=v["num_attention_heads"], layer_norm_eps=v["layer_norm_eps"], dtype=dtype)
    model = apply_knobs(FrameFusionModel(family="llava_video", cfg=llm_config(text, dtype), params=params), config)
    pipe = TextPipeline(model=model, tokenizer=StubTokenizer(), vit_params=weights.siglip_tower(v, seed, device, dtype),
                        vit_cfg=vcfg, projector=weights.llava_projector(v["hidden_size"], text["hidden_size"], seed,
                                                                         device, dtype))
    return Program(pipe=pipe, port_family="llava_video", image_size=v["image_size"])


def _counters(program) -> dict:
    from framefusion_tpu_torch import preprocess

    return dict(preprocess.path_counts)


class LayerDrawn(common.Decoder):
    """The stub's reference decoder: layer l is drawn and rounded when the
    forward pass asks for it. ``most_held`` is the most layers whose
    weights were alive at once."""

    made: list = []  # every decoder made, for the tests to look at

    def __init__(self, config: dict, seed: int, device, precision: common.Precision):
        resident = {leaf: _draw(config, seed, leaf, -1, device) for leaf in ("embed", "final_norm", "lm_head")}
        super().__init__(config["text"], resident, precision)
        self.config, self.seed, self.device = config, seed, device
        self.alive: list = []  # (layer, weakref to one of its tensors)
        self.most_held = 0
        LayerDrawn.made.append(self)

    def layer(self, l: int) -> dict:
        held = {i for i, ref in self.alive if ref() is not None}
        self.most_held = max(self.most_held, len(held | {l}))
        out = {}
        for leaf in _shapes(self.text):
            t = _draw(self.config, self.seed, leaf, l, self.device)
            out[leaf] = t.float() if t.dim() == 1 else common.decoder_matrix(t, self.precision)
            self.alive.append((l, weakref.ref(out[leaf])))
        return out


@pytest.fixture
def stub_kind(monkeypatch):
    family = types.ModuleType(f"ffbench.families.{KIND}")
    family.build, family.tower_work, family.counters = _build, llava_family.tower_work, _counters
    ref = types.ModuleType(f"ffbench.reference.{KIND}")
    for name in ("MEAN", "STD", "features", "prompt", "tower_weights"):
        setattr(ref, name, getattr(llava_reference, name))
    ref.decoder = LayerDrawn
    monkeypatch.setitem(sys.modules, family.__name__, family)
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setattr(LayerDrawn, "made", [])
    return LayerDrawn.made


def _stub_bench(tmp_path):
    """The tiny benchmark with one more configuration of the stub's kind,
    its cell, and two readers: the counter over the traced window, and the
    window's own count of the requests ingested while it was open."""
    bench = tiny.make_bench(tmp_path)
    cfg = dict(tiny.CONFIGS["tiny-llava"], kind=KIND, name="tiny-stub", source="test", quantize="int8",
               dtype="float32")
    (bench.dir / "configs" / "tiny-stub.json").write_text(json.dumps(cfg))
    bench.data["configs"].append({"name": "tiny-stub", "source": "test", "file": "ffbench/configs/tiny-stub.json",
                                  "reduced": [], "why": "test"})
    bench.data["workloads"].append({"name": WORKLOAD, "config": "tiny-stub", "traffic": "qa", "chips": 1,
                                    "why": "test"})
    (bench.dir / "cells" / f"{WORKLOAD}.json").write_text((bench.dir / "cells" / "llava7b.qa.json").read_text())
    (bench.dir / "metrics" / "counted_ingests.qa.py").write_text(
        "def read(run):\n    return None if run.counters is None else float(run.counters['native_u8'])\n")
    (bench.dir / "metrics" / "traced_ingests.qa.py").write_text(
        "def read(run):\n    return float(len(run.traced_ingests()))\n")
    bench.data["per_layer"] += [{"name": n, "unit": "requests", "better": "higher", "source": "program_counter",
                                 "layer": "test", "moves": "answer_p90_ms", "workloads": [WORKLOAD]}
                                for n in ("counted_ingests.qa", "traced_ingests.qa")]
    return bench


def test_the_check_draws_the_kinds_own_decoder_a_layer_at_a_time(tmp_path, stub_kind):
    bench = _stub_bench(tmp_path)
    result, checks = run.run_cell(bench, WORKLOAD, SEED, 2.0, False, device="cpu", control=True)
    assert result["correct"], checks
    assert checks["logit_gap"]["value"] < 1e-4 and checks["events_differ"]["value"] == 0
    assert [d.precision for d in stub_kind] == [common.REFERENCE, common.CONTROL]
    layers = bench.config("tiny-stub")["text"]["num_hidden_layers"]
    for dec in stub_kind:  # each layer drawn once for the whole sample, and freed before the next
        assert dec.most_held == 1
        assert [l for l, _ in dec.alive] == [l for l in range(layers) for _ in _shapes(dec.text)]
        assert all(ref() is None for _, ref in dec.alive)
    assert checks["control.logit_gap"]["value"] > 10 * checks["logit_gap"]["value"]


def test_the_kinds_counters_reach_a_reader_as_close_less_open(tmp_path, stub_kind):
    from framefusion_tpu_torch import preprocess

    bench = _stub_bench(tmp_path)
    before = preprocess.path_counts["native_u8"]
    result, _ = run.run_cell(bench, WORKLOAD, SEED, 3.0, True, device="cpu")
    total = preprocess.path_counts["native_u8"] - before  # warm-up and every request, in and out of the window
    counted = result["metrics"]["counted_ingests.qa"]["value"]
    assert counted == result["metrics"]["traced_ingests.qa"]["value"]
    assert 0 < counted < total
    assert result["correct"]


def test_a_kind_without_counters_gives_readers_none(tmp_path):
    bench = tiny.make_bench(tmp_path)
    (bench.dir / "metrics" / "counted_ingests.qa.py").write_text(
        "def read(run):\n    assert run.counters is None\n    return 1.0\n")
    bench.data["per_layer"].append({"name": "counted_ingests.qa", "unit": "requests", "better": "higher",
                                    "source": "program_counter", "layer": "test", "moves": "answer_p90_ms",
                                    "workloads": ["llava7b.qa"]})
    result, _ = run.run_cell(bench, "llava7b.qa", SEED, 3.0, True, device="cpu")
    assert result["metrics"]["counted_ingests.qa"]["value"] == 1.0


@pytest.mark.parametrize("workload", ["llava7b.qa", "internvl8b.qa"])
def test_kinds_without_a_decoder_read_as_before(tiny_bench, monkeypatch, workload):
    calls = []
    readings = check.readings

    def spy(config, seed, samples, device, control=False):
        calls.append((config, seed, samples, device))
        return readings(config, seed, samples, device, control=control)

    monkeypatch.setattr(check, "readings", spy)
    _, checks = run.run_cell(tiny_bench, workload, SEED, 2.0, False, device="cpu", control=True)
    assert len(calls) == 1
    config, seed, samples, device = calls[0]
    assert len(samples) > 1 and not hasattr(reference.load(config["kind"]), "decoder")
    got = readings(config, seed, samples, device, control=True)
    assert got == {k: c["value"] for k, c in checks.items() if k not in ("unfinished", "short_answers")}
    before = before_seam.readings(config, seed, samples, device, control=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(before, sort_keys=True)


def test_a_keyed_stream_is_its_own():
    """Each (leaf, layer) draws the same tensor alone as among the others,
    and no two keys, nor the dense stream, share their draws."""
    draw = lambda key: weights.Draws(SEED, 0, "cpu", torch.float32, key=key).normal(64)  # noqa: E731
    assert torch.equal(draw(("wq", 3)), draw(("wq", 3)))
    tensors = [draw(k) for k in (("wq", 3), ("wq", 4), ("wk", 3), ("embed", -1))]
    tensors.append(weights.Draws(SEED, 0, "cpu", torch.float32).normal(64))
    for i in range(len(tensors)):
        for j in range(i):
            assert not torch.equal(tensors[i], tensors[j])
