"""PyTorch port vs the JAX package and HF transformers: the Qwen2.5-VL tower.

* ``window_layout`` / ``padded_window_layout``: EQUAL to JAX's arrays on an
  exact-window grid, a grid with ragged edge windows (JAX's
  tests/test_vision.py grids) and the published geometry's grid.
* ``encode_video`` with "flash" (kernel E's plain version on the CPU),
  "einsum" and "masked" against JAX's ``encode_video`` ("windowed-interpret":
  E interpreted; "masked": the oracle) on the same numpy weights and frames:
  ``TOWER_TOL`` of the largest feature, fp32 both sides (JAX's own bound
  against HF, tests/test_vision.py).
* The tower against HF ``Qwen2_5_VisionTransformerPretrainedModel`` through
  ``params_from_hf``, on both grids: ``TOWER_TOL``.
* ``qwen25_vl_72b_config`` equals JAX's.
* ``gpu``: the tower at head dim 80 on the card (kernel E in its
  full-attention block) against its plain run on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.config import qwen25_vl_72b_config as jax_72b
from framefusion_tpu.models.vision import qwen25_vl_vit as jvit
from framefusion_tpu.models.vision.qwen2_vl_vit import pixels_to_patches as jax_pixels_to_patches
from framefusion_tpu_torch.config import qwen25_vl_72b_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.vision import qwen25_vl_vit as tvit
from framefusion_tpu_torch.models.vision.qwen2_vl_vit import pixels_to_patches
from framefusion_tpu_torch.ops.kernels import bidir_attention as tba

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOWER_TOL = 3e-4
# (frames shape, grid): 4 x 4 patches fill one 28-pixel window of 2 x 2
# merge units exactly; 6 x 8 leaves ragged windows at both edges.
GRIDS = {"exact": ((4, 28, 28, 3), (2, 4, 4)), "ragged": ((6, 42, 56, 3), (3, 6, 8))}


def numpy_tower(cfg, seed: int, scale: float = 0.05) -> dict:
    """Random tower weights in the JAX package's pytree layout, drawn with
    numpy: every bias and norm weight away from its neutral value, so a
    misplaced one shows."""
    rng = np.random.default_rng(seed)
    d, i, n_l, mu = cfg.hidden_size, cfg.intermediate_size, cfg.depth, cfg.merge_unit

    def norm(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    layers = {"ln1_w": 1 + norm(n_l, d), "ln2_w": 1 + norm(n_l, d), "w_qkv": norm(n_l, d, 3 * d),
              "b_qkv": norm(n_l, 3 * d), "wo": norm(n_l, d, d), "bo": norm(n_l, d), "w_gate": norm(n_l, d, i),
              "b_gate": norm(n_l, i), "w_up": norm(n_l, d, i), "b_up": norm(n_l, i), "w_down": norm(n_l, i, d),
              "b_down": norm(n_l, d)}
    return {"patch_proj": norm(cfg.patch_dim, d), "layers": layers, "merger_ln_w": 1 + norm(d),
            "merger_w0": norm(mu * d, mu * d), "merger_b0": norm(mu * d),
            "merger_w1": norm(mu * d, cfg.out_hidden_size), "merger_b1": norm(cfg.out_hidden_size)}


def cast(tree, dtype):
    return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def frames_of(shape):
    return np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("grid_name", ["exact", "ragged", "published"])
def test_window_layouts_equal_jax(grid_name):
    if grid_name == "published":  # Qwen2.5-VL-7B's tower at 364 x 476 frames
        jcfg, tcfg, grid = jvit.Qwen25VLViTConfig(), tvit.Qwen25VLViTConfig(), (3, 26, 34)
    else:
        jcfg, tcfg, grid = jvit.tiny_qwen25vl_vit_config(), tvit.tiny_qwen25vl_vit_config(), GRIDS[grid_name][1]
    for name, got, want in zip(("window_index", "token_perm", "inv_perm", "seg_window", "seg_full"),
                               tvit.window_layout(*grid, tcfg), jvit.window_layout(*grid, jcfg)):
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype, name
    for name, got, want in zip(("win_gather", "win_valid", "back_idx"), tvit.padded_window_layout(*grid, tcfg),
                               jvit.padded_window_layout(*grid, jcfg)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    wg, wv, back = tvit.padded_window_layout(*grid, tcfg)
    n = int(np.prod(grid))
    assert wv.shape[1] == (tcfg.window_size // tcfg.spatial_merge_size // tcfg.patch_size) ** 2 * tcfg.merge_unit
    assert sorted(wg[wv].tolist()) == list(range(n)) and back.shape == (n,)
    if grid_name != "exact":
        assert not wv.all()  # ragged edge windows: some slots are masked keys


@pytest.mark.parametrize("impl", ["flash", "einsum", "masked"])
@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_tower_matches_jax(grid_name, impl):
    """The port's three paths against JAX's "windowed-interpret" (kernel E
    interpreted in the full-attention block) and its "masked" oracle."""
    shape, grid = GRIDS[grid_name]
    jcfg, tcfg = jvit.tiny_qwen25vl_vit_config(), tvit.tiny_qwen25vl_vit_config()
    weights = numpy_tower(tcfg, seed=3)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = tq.params_from_numpy(weights, device="cpu")
    patches, got_grid = pixels_to_patches(frames_of(shape), tcfg)
    assert got_grid == grid
    got = tvit.encode_video(tp, patches, *grid, tcfg, attn_impl=impl).numpy()
    assert got.shape == (np.prod(grid) // 4, tcfg.out_hidden_size)
    for jax_impl in ("windowed-interpret", "masked"):
        want = np.asarray(jvit.encode_video(jp, jnp.asarray(patches), *grid, jcfg, attn_impl=jax_impl))
        np.testing.assert_allclose(got, want, atol=TOWER_TOL * np.abs(want).max(), err_msg=jax_impl)


def test_tower_checks_its_inputs():
    cfg = tvit.tiny_qwen25vl_vit_config()
    tp = tq.params_from_numpy(numpy_tower(cfg, seed=0), device="cpu")
    patches, grid = pixels_to_patches(frames_of((4, 28, 28, 3)), cfg)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tvit.encode_video(tp, patches, *grid, cfg, attn_impl="windowed")
    with pytest.raises(ValueError, match="do not match the grid"):
        tvit.encode_video(tp, patches[:-1], *grid, cfg)


@pytest.fixture(scope="module")
def hf_tower():
    """A random tiny HF ``Qwen2_5_VisionTransformerPretrainedModel`` (fp32,
    eager attention) at the tiny config's geometry (JAX's
    tests/test_vision.py ``make_hf_qwen25vl_tower``)."""
    from transformers import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VisionTransformerPretrainedModel

    vc = Qwen2_5_VLConfig(vision_config=dict(depth=3, hidden_size=64, num_heads=4, intermediate_size=96,
                                             patch_size=7, temporal_patch_size=2, spatial_merge_size=2,
                                             window_size=28, fullatt_block_indexes=[1], out_hidden_size=32,
                                             in_channels=3)).vision_config
    vc._attn_implementation = "eager"
    torch.manual_seed(0)
    return Qwen2_5_VisionTransformerPretrainedModel._from_config(vc).eval()


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_tower_matches_hf(hf_tower, grid_name):
    shape, grid = GRIDS[grid_name]
    cfg = tvit.tiny_qwen25vl_vit_config()
    params = tvit.params_from_hf(hf_tower.state_dict(), cfg, prefix="", device="cpu")
    patches, got_grid = pixels_to_patches(frames_of(shape), cfg)
    jax_patches, _ = jax_pixels_to_patches(frames_of(shape), jvit.tiny_qwen25vl_vit_config())
    np.testing.assert_array_equal(patches, jax_patches)  # the patch layout both towers share
    with torch.no_grad():
        want = hf_tower(torch.tensor(patches), grid_thw=torch.tensor([got_grid]))
    for impl in ("flash", "einsum", "masked"):
        torch.testing.assert_close(tvit.encode_video(params, patches, *grid, cfg, attn_impl=impl), want,
                                   rtol=TOWER_TOL, atol=TOWER_TOL, msg=impl)


def test_qwen25_vl_72b_config_matches_jax():
    got, want = dataclasses.asdict(qwen25_vl_72b_config()), dataclasses.asdict(jax_72b())
    assert got.pop("dtype") == torch.bfloat16 and jnp.dtype(want.pop("dtype")).name == "bfloat16"
    for key, value in got.items():
        assert want[key] == value, key
    assert (got["hidden_size"], got["num_heads"], got["num_kv_heads"], got["intermediate_size"]) == \
        (8192, 64, 8, 29568)
    assert qwen25_vl_72b_config(num_layers=16).num_layers == 16
    # The tower's defaults are the published one's (7B and 72B share it but
    # for the merger's output width).
    assert dataclasses.asdict(tvit.Qwen25VLViTConfig()) | {"dtype": None} == \
        dataclasses.asdict(jvit.Qwen25VLViTConfig()) | {"dtype": None}


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_tower_at_head_dim_80(cuda):
    """The tower at head dim 80 (hidden 160, 2 heads) with one full-attention
    block on the ragged grid: bf16 on the card (kernel E launched once)
    against the fp32 plain run on the CPU, within 3e-2 of the largest
    feature (a bf16 tower against an fp32 one, tests/test_torch_qwen2vl_io.py's
    bound)."""
    cfg = tvit.tiny_qwen25vl_vit_config(hidden_size=160, num_heads=2, intermediate_size=256)
    weights = numpy_tower(cfg, seed=5)
    patches, grid = pixels_to_patches(frames_of(GRIDS["ragged"][0]), cfg)
    want = tvit.encode_video(tq.params_from_numpy(weights, device="cpu"), patches, *grid, cfg, attn_impl="einsum")
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = cast(tq.params_from_numpy(weights, device=cuda), torch.bfloat16)
    launches = tba.bidir_attn_fwd.launches
    got = tvit.encode_video(params, patches, *grid, bf16, attn_impl="flash")
    torch.cuda.synchronize()
    assert tba.bidir_attn_fwd.launches == launches + len(cfg.fullatt_block_indexes)
    err = (got.float().cpu() - want).abs().max() / want.abs().max()
    assert err <= 3e-2, err
