"""PyTorch port vs the JAX package: ``framefusion_tpu_torch.utils`` against
``framefusion_tpu.utils`` (the dot-path resolver on the port's params and
modules, the frame dumps byte for byte), and the loader's message for a
family no package knows."""

import json

import jax
import numpy as np
import pytest
import torch

from framefusion_tpu import utils as jutils
from framefusion_tpu_torch import utils as tutils
from framefusion_tpu_torch.models import qwen2 as tq

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    from framefusion_tpu_torch.config import tiny_llm_config

    tree = jax.tree.map(lambda t: t.numpy(), tq.init_params(tiny_llm_config(num_layers=2),
                                                             torch.Generator().manual_seed(0)))
    return tree, tq.params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("path", ["embed", "layers.wq", "layers.wq.1", "layers.ln1.0", "final_norm", "lm_head"])
def test_get_attr_by_name_resolves_jax_paths(params, path):
    """A path into the JAX layout's params (numpy) names the same values in
    the port's."""
    jp, tp = params
    want = np.asarray(jutils.get_attr_by_name(jp, path), np.float32)
    got = tutils.get_attr_by_name(tp, path)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)
    assert torch.equal(tutils.tree_path_get(tp, path), got)


def test_get_attr_by_name_walks_modules_and_sequences():
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ModuleList([torch.nn.ReLU(), torch.nn.Linear(4, 2)]))
    assert tutils.get_attr_by_name(net, "1.1.weight") is net[1][1].weight
    assert tutils.get_attr_by_name(net, "0.bias") is net[0].bias
    tree = {"blocks": [{"w": 1}, {"w": 2}], "cfg": json}
    assert tutils.get_attr_by_name(tree, "blocks.1.w") == jutils.get_attr_by_name(tree, "blocks.1.w") == 2
    assert tutils.get_attr_by_name(tree, "cfg.dumps") is json.dumps
    with pytest.raises(KeyError):
        tutils.get_attr_by_name(tree, "nope")


def test_frame_dumps_equal_jax_byte_for_byte(tmp_path):
    """The PNG dumps of a [-1, 1] video (values past the range clip) equal
    JAX's file for file, from a numpy array and from a tensor; the grid
    figure is written."""
    video = np.random.default_rng(0).uniform(-1.2, 1.2, (5, 12, 10, 3)).astype(np.float32)
    jutils.save_video_frames(video, str(tmp_path / "jax"))
    tutils.save_video_frames(video, str(tmp_path / "np"))
    tutils.save_video_frames(torch.from_numpy(video), str(tmp_path / "tensor"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"frame_{i}.png" for i in range(5)]
    for sub in ("np", "tensor"):
        assert sorted(p.name for p in (tmp_path / sub).iterdir()) == names
        for n in names:
            assert (tmp_path / sub / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
    out = tmp_path / "grid" / "frames.jpg"
    tutils.save_video_frames_subfigures(torch.from_numpy(video), str(out))
    assert out.stat().st_size > 0


def test_load_checkpoint_names_the_families_for_an_unknown_one(tmp_path):
    from framefusion_tpu_torch.interface import FAMILIES
    from framefusion_tpu_torch.weights import load_checkpoint

    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["LlavaQwenForCausalLM"], "model_type": "qwen2", "vocab_size": 64, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 1, "num_attention_heads": 2, "num_key_value_heads": 1}))
    with pytest.raises(NotImplementedError) as err:
        load_checkpoint(str(tmp_path), family="llava_onevision", device="cpu")
    msg = str(err.value)
    assert "llava_onevision" in msg and all(f in msg for f in FAMILIES) and "ROADMAP" not in msg
