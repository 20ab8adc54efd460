"""The port's safetensors reader and the names it took from the JAX package
last, against the ``safetensors`` package and the JAX package.

* The reader (``framefusion_tpu_torch.safetensors_io``) gives the bits the
  ``safetensors`` package gives, tensor for tensor, on every family's hub
  fixture and on a file holding each dtype it takes (a 0-d and an empty
  tensor among them); a dtype it does not take, an offset past the data
  and a shard the index names but that is missing raise.
* ``load_checkpoint`` loads with the ``safetensors`` module blocked, and
  equals the import of the package's tensors bit for bit.
* ``load_safetensors`` equals JAX's leaf for leaf in fp32 and int8 (the
  port's pairs quantized by ``quantize_weight`` on the CPU, JAX's by its
  numpy twin: the same fp32 quotients, equal bits).
* ``qwen2_1_5b_config``, ``plan_length`` and ``native.normalize_frames``
  equal JAX's; ``causal_attention("einsum")`` agrees with JAX's to 1e-5
  (the same fp32 math at O(1) magnitudes, summed in other orders).
* ``runtime.profiling``'s ``force``, ``timeit`` and ``trace`` on the CPU;
  ``param_shardings`` names the dims ``shard_params`` splits.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from checkpoint_fixtures import write_fixture
from framefusion_tpu import config as jconfig
from framefusion_tpu import native as jnative
from framefusion_tpu import weights as jweights
from framefusion_tpu.ops import attention as jattn
from framefusion_tpu.runtime import engine as jengine
from framefusion_tpu_torch import config as tconfig
from framefusion_tpu_torch import native as tnative
from framefusion_tpu_torch import safetensors_io, weights
from framefusion_tpu_torch.ops import attention as tattn
from framefusion_tpu_torch.parallel import sharding
from framefusion_tpu_torch.runtime import engine as tengine
from framefusion_tpu_torch.runtime import profiling

torch.set_num_threads(1)

FAMILIES = ("llava_video", "llava_next_video", "minicpmv", "nvila", "qwen2_vl", "qwen25_vl", "internvl")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert (g.dtype, tuple(g.shape)) == (w.dtype, tuple(w.shape)), name
        assert torch.equal(_bits(g), _bits(w)), name


def _shards(path: str) -> list:
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))


@pytest.mark.parametrize("family", FAMILIES)
def test_reader_equals_the_package_on_every_fixture(tmp_path, family):
    path = write_fixture(tmp_path, family)
    want = {}
    for shard in _shards(path):
        got = safetensors_io.read_file(shard)
        _same(got, load_file(shard))
        want.update(got)
    _same(weights.load_state(path), want)


def test_reader_takes_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {str(d).removeprefix("torch."): (torch.randn(3, 5, generator=gen) * 100).to(d)
               for d in (torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8, torch.uint8,
                         torch.int16, torch.int32, torch.int64)}
    tensors["bool"] = torch.randn(7, generator=gen) > 0
    tensors["scalar"] = torch.tensor(2.5, dtype=torch.bfloat16)
    tensors["empty"] = torch.zeros((0, 3), dtype=torch.float32)
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = safetensors_io.read_file(path)
    _same(got, load_file(path))
    assert {k: v.dtype for k, v in got.items()} == {k: v.dtype for k, v in tensors.items()}
    got["float32"] += 1  # the map is copy-on-write: the file keeps its bytes
    _same(safetensors_io.read_file(path), load_file(path))


def test_reader_refuses_an_unknown_dtype(tmp_path):
    path = str(tmp_path / "f8.safetensors")
    save_file({"ok": torch.ones(2), "odd": torch.ones(4).to(torch.float8_e4m3fn)}, path)
    with pytest.raises(ValueError, match="'odd' has dtype 'F8_E4M3'"):
        safetensors_io.read_file(path)


def test_reader_refuses_an_offset_past_the_data(tmp_path):
    path = tmp_path / "short.safetensors"
    save_file({"a": torch.ones(4), "b": torch.ones(8)}, str(path))
    header, _, n_data = safetensors_io.read_header(str(path))
    last = max(header, key=lambda k: header[k]["data_offsets"][1])
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match=f"tensor '{last}'.*data section of {n_data - 4} bytes"):
        safetensors_io.read_file(str(path))


def test_load_state_refuses_a_missing_shard(tmp_path):
    path = write_fixture(tmp_path, "llava_video")
    gone = os.path.basename(_shards(path)[-1])
    os.remove(os.path.join(path, gone))
    with pytest.raises(FileNotFoundError, match=gone):
        weights.load_state(path)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_checkpoint_needs_no_safetensors_package(tmp_path, monkeypatch, quantize):
    path = write_fixture(tmp_path, "llava_video")
    package_state = {}
    for shard in _shards(path):
        package_state.update(load_file(shard))
    with open(os.path.join(path, "config.json")) as f:
        _, cfg = weights.llm_config_from_hf(json.load(f))
    want = weights.params_from_state_dict(package_state, cfg, quantize=quantize, device="cpu")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    model = weights.load_checkpoint(path, quantize=quantize, device="cpu")
    assert model.vision is not None and model.vision["projector"] is not None
    got, ref = dict(_leaves(model.params)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for name, t in got.items():
        assert t.dtype == ref[name].dtype and torch.equal(t, ref[name]), name
        assert t.is_contiguous(), name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_safetensors_matches_jax(tmp_path, quantize):
    path = write_fixture(tmp_path, "llava_video")
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    _, jcfg = jweights.llm_config_from_hf(cfg_dict, dtype=jnp.float32)
    _, tcfg = weights.llm_config_from_hf(cfg_dict, dtype=torch.float32)
    ref = dict(_leaves(jweights.load_safetensors(path, jcfg, quantize=quantize)))
    got = dict(_leaves(weights.load_safetensors(path, tcfg, quantize=quantize, device="cpu")))
    assert got.keys() == ref.keys()
    for name, t in got.items():
        j = np.asarray(ref[name])
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    assert ("/layers/wq/q8" in got) == (quantize == "int8")


def test_qwen2_1_5b_config_matches_jax():
    got, want = tconfig.qwen2_1_5b_config(), jconfig.qwen2_1_5b_config()
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name
        else:
            assert g == w, f.name
    assert tconfig.qwen2_1_5b_config(num_layers=4).num_layers == 4


@pytest.mark.parametrize("cost", [0.1, 0.3, 0.5, 0.9])
def test_plan_length_matches_jax(cost):
    for layers, bucket in ((28, 128), (4, 32)):
        tff = tconfig.FrameFusionConfig(cost=cost, schedule_num_layers=layers, bucket=bucket)
        jff = jconfig.FrameFusionConfig(cost=cost, schedule_num_layers=layers, bucket=bucket)
        for orig_len in (67, 1234, 11697, 23345):
            for image_len in sorted({0, orig_len // 3, orig_len - 49}):
                for events, margin in ((4, 1.05), (1, 1.0), (40, 1.2)):
                    assert tengine.plan_length(orig_len, image_len, tff, events, margin) == jengine.plan_length(
                        orig_len, image_len, jff, events, margin), (orig_len, image_len, events, margin)


@pytest.mark.parametrize("masked", [False, True])
def test_causal_attention_matches_jax(masked):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((37, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((37, 2, 16), dtype=np.float32) for _ in range(2))
    kv = (rng.random(37) > 0.3) if masked else None
    ref = np.asarray(jattn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), "einsum",
                                            key_valid=None if kv is None else jnp.asarray(kv)))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tkv = None if kv is None else torch.from_numpy(kv)
    got = tattn.causal_attention(*args, "einsum", key_valid=tkv)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    for impl in ("flash", "pallas"):  # kernel A's plain version on CPU tensors
        np.testing.assert_allclose(tattn.causal_attention(*args, impl, key_valid=tkv).numpy(), ref, atol=1e-5,
                                   rtol=0)
    with pytest.raises(NotImplementedError, match="chunked"):
        tattn.causal_attention(*args, "chunked")
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.causal_attention(*args, "stub")


def test_normalize_frames_matches_jax():
    frames = np.random.default_rng(7).integers(0, 256, (3, 17, 23, 3)).astype(np.float32)
    mean, std, rescale = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 1 / 255
    ref = jnative.normalize_frames(jnative.load(required=True), frames.copy(), mean, std, rescale)
    lib = tnative.load(required=True)
    got = tnative.normalize_frames(lib, frames.copy(), mean, std, rescale)
    np.testing.assert_array_equal(got, ref)
    plain = (frames * np.float32(rescale) - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    inplace = frames.copy()
    assert tnative.normalize_frames(lib, inplace, mean, std, rescale) is inplace
    with pytest.raises(ValueError, match="3 channels"):
        tnative.normalize_frames(lib, frames.copy(), mean[:2], std[:2], rescale)


def test_put_copies_only_when_it_must():
    t = torch.randn(4, 3)
    assert weights._put(t, torch.device("cpu"), torch.float32).data_ptr() == t.data_ptr()
    got = weights._put(t.T, torch.device("cpu"), torch.bfloat16)
    assert got.is_contiguous() and torch.equal(got, t.T.to(torch.bfloat16))


def test_profiling_force_timeit_and_trace_on_the_cpu(tmp_path):
    assert profiling.force(torch.arange(5)) == 10.0
    assert profiling.force(np.ones((2, 3))) == 6.0
    calls = []

    def fn():
        calls.append(1)
        return torch.full((4,), float(len(calls)))

    seconds, out = profiling.timeit(fn, probe=lambda o: o[:1], reps=4)
    assert seconds >= 0 and len(calls) == 5 and float(out[0]) == 5.0
    seconds, out = profiling.timeit(fn, reps=2, warmup=False)
    assert len(calls) == 8 and float(out[0]) == 8.0
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace_file,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, trace_file)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("axis,width", [("tensor", 2), ("tensor", 4), ("stage", 2)])
def test_param_shardings_names_the_dims_shard_params_splits(axis, width):
    from torch.distributed.tensor import Replicate, Shard

    cfg = tconfig.tiny_llm_config(num_layers=4, vocab_size=256)
    params = sharding.init_sharded_params(cfg, 3, device="cpu")
    places = dict(_leaves(sharding.param_shardings(cfg, sharding.ShardAxis(axis, 0, width))))
    assert places.keys() == dict(_leaves(params)).keys()
    for rank in range(width):
        shard = dict(_leaves(sharding.shard_params(params, cfg, sharding.ShardAxis(axis, rank, width))))
        for name, x in _leaves(params):
            data, split = places[name]
            assert data == Replicate(), name
            want = x if split == Replicate() else x.tensor_split(width, dim=split.dim)[rank]
            assert isinstance(split, (Replicate, Shard)) and torch.equal(shard[name], want), (name, rank)
