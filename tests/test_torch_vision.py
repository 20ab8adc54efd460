"""The port's pixels-to-features path vs the JAX package.

Inputs are drawn with numpy from a seed and go through the JAX function and
its port; JAX weights carry over with ``params_from_numpy``. Tolerances:

* fp32 paths (kernel E's plain version vs the Pallas kernel in interpret
  mode, the SigLIP tower, the frontend) agree to 1e-5 absolute at these
  O(1) magnitudes: the same fp32 math summed in other orders.
* The W8A8 tower quantizes each layer's activations to int8; inputs that
  differ in the last fp32 bit can round to neighbouring int8 steps, so the
  tower's features agree to 1e-3 of their largest magnitude (one int8 step
  of one activation is 1/127 of its row's largest, spread over a 64-wide
  contraction). ``mm`` itself, given the same inputs, agrees to fp32
  rounding (1e-6 relative).
* Adapter arrays, preprocessing on the same path, and every checkpoint
  tensor are compared for equality.

The ``gpu``-marked test holds kernel E against its plain version on a card
(``python -m pytest -m gpu tests/test_torch_vision.py`` there); here it skips.
"""

import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import write_fixture
from framefusion_tpu import preprocess as jpp
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters import llava_video as jlv
from framefusion_tpu.models.vision import llava_frontend as jlf
from framefusion_tpu.models.vision import siglip as js
from framefusion_tpu.ops import quant as jquant
from framefusion_tpu.ops.kernels.bidir_attention import flash_bidir_attention as jax_bidir
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu_torch import interface, preprocess as tpp
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import llava_video as tlv
from framefusion_tpu_torch.models.vision import llava_frontend as tlf
from framefusion_tpu_torch.models.vision import siglip as ts
from framefusion_tpu_torch.ops import quant as tquant
from framefusion_tpu_torch.ops.kernels import bidir_attention as tba
from framefusion_tpu_torch.weights import load_checkpoint, llm_config_from_hf

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOL = 1e-5
W8A8_RTOL = 1e-3


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def tower():
    cfg = js.tiny_vit_config()
    jp = js.init_params(cfg, jax.random.PRNGKey(1))
    return cfg, ts.tiny_vit_config(), jp, ts.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("b,n,h,hd", [(2, 37, 4, 16), (1, 49, 2, 72), (2, 9, 4, 16), (1, 130, 2, 8)])
def test_bidir_plain_matches_pallas(b, n, h, hd):
    rng = np.random.default_rng(n)
    q, k, v = (_normal(rng, b, n, h, hd) for _ in range(3))
    ref = np.asarray(jax_bidir(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = tba.flash_bidir_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_bidir_wrapper_checks_its_inputs():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        tba.bidir_attn_fwd(x, torch.zeros(1, 5, 2, 8), x, 1.0)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tba.bidir_attn_fwd(x.to("meta"), x.to("meta"), x.to("meta"), 1.0)


@pytest.mark.parametrize("jax_impl", ["einsum", "interpret"])
@pytest.mark.parametrize("port_impl", ["flash", "einsum"])
@pytest.mark.parametrize("feature_layer", [-1, -2])
def test_siglip_encode_matches_jax(tower, feature_layer, port_impl, jax_impl):
    jcfg, tcfg, jp, tp = tower
    px = _normal(np.random.default_rng(2), 3, 28, 28, 3)
    ref = np.asarray(js.encode(jp, jnp.asarray(px), jcfg, feature_layer=feature_layer, attn_impl=jax_impl))
    got = ts.encode(tp, px, tcfg, feature_layer=feature_layer, attn_impl=port_impl)
    assert got.shape == (3, tcfg.num_patches, tcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("w8a8", [False, True])
def test_int8_tower_matches_jax(tower, w8a8):
    jcfg, tcfg, jp, _ = tower
    qj = js.quantize_tower_int8(jax.tree.map(jnp.asarray, jp))
    qt = ts.quantize_tower_int8(ts.params_from_numpy(jax.device_get(jp), device="cpu"))
    for name in ts.QUANTIZED_TOWER_WEIGHTS:
        assert qt["layers"][name]["q8"].dtype == torch.int8
        np.testing.assert_array_equal(qt["layers"][name]["q8"].numpy(), np.asarray(qj["layers"][name]["q8"]))
    px = _normal(np.random.default_rng(3), 2, 28, 28, 3)
    ref = np.asarray(js.encode(qj, jnp.asarray(px), jcfg, feature_layer=-2, w8a8=w8a8))
    got = ts.encode(qt, px, tcfg, feature_layer=-2, w8a8=w8a8).numpy()
    atol = W8A8_RTOL * float(np.abs(ref).max()) if w8a8 else TOL
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0 if w8a8 else TOL)


def test_w8a8_mm_and_host_quantization_match_jax():
    rng = np.random.default_rng(4)
    w = _normal(rng, 3, 64, 48)
    qj, qt = jquant.quantize_weight_host(w), tquant.quantize_weight_host(w)
    np.testing.assert_array_equal(qt["q8"], qj["q8"])
    np.testing.assert_array_equal(qt["scale"], qj["scale"])
    x = _normal(rng, 2, 5, 64)
    ref = np.asarray(jq.mm(jnp.asarray(x), {"q8": jnp.asarray(qj["q8"][1]), "scale": jnp.asarray(qj["scale"][1])},
                           w8a8=True))
    got = tq.mm(torch.from_numpy(x), {"q8": torch.from_numpy(qt["q8"][1]), "scale": torch.from_numpy(qt["scale"][1])},
                w8a8=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * float(np.abs(ref).max()), rtol=0)


def test_encode_video_matches_jax(tower):
    jcfg, tcfg, jp, tp = tower
    proj = jlf.init_projector(jax.random.PRNGKey(2), jcfg.hidden_size, 32)
    tproj = tlf.params_from_numpy(jax.device_get(proj), device="cpu")
    frames = _normal(np.random.default_rng(5), 5, 28, 28, 3)
    ref = np.asarray(jlf.encode_video(jp, jcfg, proj, jnp.asarray(frames), frame_batch=2, attn_impl="einsum"))
    got = tlf.encode_video(tp, tcfg, tproj, frames, frame_batch=2)
    side = tcfg.patches_per_side // 2
    assert got.shape == ref.shape == (5 * side * (side + 1), 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("pool_mode,side", [("average", 4), ("bilinear", 5), ("average", 27)])
def test_build_prefill_inputs_matches_jax(pool_mode, side, as_tensor):
    rng = np.random.default_rng(side)
    patch = -(-side // 2) if pool_mode == "bilinear" else side // 2
    text = _normal(rng, 9, 16)
    feats = _normal(rng, 3 * patch * (patch + 1), 16)
    ref = jlv.build_prefill_inputs(text, feats, 4, num_patches_per_side=side, spatial_pool_mode=pool_mode)
    wrap = torch.from_numpy if as_tensor else np.asarray
    got = tlv.build_prefill_inputs(wrap(text), wrap(feats), 4, num_patches_per_side=side, spatial_pool_mode=pool_mode)
    np.testing.assert_array_equal(np.asarray(got.input_embeds), ref.input_embeds)
    np.testing.assert_array_equal(got.patch_type, ref.patch_type)
    np.testing.assert_array_equal(got.position_ids, ref.position_ids)
    assert (got.patch_num, got.image_token_start, got.image_token_length, got.num_importance_queries) == (
        ref.patch_num, ref.image_token_start, ref.image_token_length, ref.num_importance_queries)
    with pytest.raises(ValueError, match="not a multiple"):
        tlv.build_prefill_inputs(wrap(text), wrap(feats[1:]), 4, num_patches_per_side=side,
                                 spatial_pool_mode=pool_mode)


@pytest.mark.parametrize("impl", ["numpy", "native"])
@pytest.mark.parametrize("geom", [((45, 61), (28, 28)), ((17, 23), (40, 56))])
def test_preprocess_matches_jax(impl, geom):
    (h, w), target = geom
    frames = np.random.default_rng(h).integers(0, 256, (3, h, w, 3)).astype(np.uint8)
    ref = jpp.preprocess_frames(frames, "llava_video", target=target, impl=impl)
    got = tpp.preprocess_frames(frames, "llava_video", target=target, impl=impl)
    np.testing.assert_array_equal(got, ref)
    # the numpy and native twins agree to fp32 accumulation order
    other = tpp.preprocess_frames(frames, "llava_video", target=target, impl="native" if impl == "numpy" else "numpy")
    np.testing.assert_allclose(got, other, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(100, 150), (480, 640), (1080, 1920), (28, 2000)])
def test_smart_resize_matches_jax(hw):
    assert tpp.smart_resize(*hw) == jpp.smart_resize(*hw)
    assert tpp.smart_resize(*hw, factor=14, max_pixels=224 * 224) == jpp.smart_resize(*hw, factor=14,
                                                                                       max_pixels=224 * 224)


def test_native_build_lands_in_the_port(monkeypatch, tmp_path):
    import framefusion_tpu_torch
    from framefusion_tpu_torch import native

    port_root = Path(framefusion_tpu_torch.__file__).resolve().parent
    assert native.SRC.is_file() and native.SRC.resolve().is_relative_to(port_root)
    # the port builds its own source (its results are held to the JAX
    # package's kernel bit for bit by test_preprocess_matches_jax), with the
    # JAX kernel's entry points and the uint8 one
    jax_src = Path(jpp.__file__).resolve().parent / "native" / "prep.cpp"
    assert native.SRC.resolve() != jax_src.resolve()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    so = native._build()
    assert so.parent == tmp_path
    lib = ctypes.CDLL(str(so))
    for entry in ("ff_resize_frames", "ff_resize_frames_u8", "ff_normalize"):
        assert hasattr(lib, entry)
    # the library's name follows its flags as well as its source
    monkeypatch.setattr(native, "_FLAGS", [*native._FLAGS, "-DFF_TAG_TEST"])
    assert native._build().name != so.name


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_checkpoint_matches_jax(tmp_path, quantize):
    """Every LLM, tower and projector tensor of the llava_video fixture equals
    the JAX loader's, bf16 and int8. The port loads the tower in bf16 where
    JAX keeps fp32: the checkpoint stores bf16, so the values are equal."""
    path = write_fixture(tmp_path, "llava_video")
    ref = jax_load_checkpoint(path, dtype=jnp.bfloat16, quantize=quantize)
    got = load_checkpoint(path, dtype=torch.bfloat16, quantize=quantize, device="cpu")
    assert got.family == ref.family == "llava_video" and got.cfg.num_layers == ref.cfg.num_layers
    trees = {"llm": (got.params, ref.params), "tower": (got.vision["params"], ref.vision["params"]),
             "projector": (got.vision["projector"], ref.vision["projector"])}
    for part, (t_tree, j_tree) in trees.items():
        t_leaves, j_leaves = dict(_tree_leaves(t_tree)), dict(_tree_leaves(jax.device_get(j_tree)))
        assert t_leaves.keys() == j_leaves.keys(), part
        for name, t in t_leaves.items():
            j = np.asarray(j_leaves[name])
            want = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}[j.dtype.name]
            if part == "tower":
                want = torch.bfloat16
            assert t.dtype == want, (part, name, t.dtype)
            np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point() else t.numpy(),
                                          j.astype(np.float32) if t.is_floating_point() else j, err_msg=f"{part}{name}")
    for attr in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers", "num_heads"):
        assert getattr(got.vision["cfg"], attr) == getattr(ref.vision["cfg"], attr)


def test_other_families_are_not_ported(tmp_path):
    """No family or backbone of the JAX map stays refused: the families
    this package takes map as JAX's do; Qwen2.5-VL, once refused, maps to
    ``qwen2_vl`` and its hub checkpoint loads with its Qwen2.5-VL tower; the
    MoE backbone, once refused, maps to llava_video with its expert fields,
    as in JAX. An architecture outside the map still raises."""
    text = {"vocab_size": 8, "hidden_size": 8, "intermediate_size": 8, "num_hidden_layers": 1,
            "num_attention_heads": 1}
    assert llm_config_from_hf({"architectures": ["Qwen2_5_VLForConditionalGeneration"], **text})[0] == "qwen2_vl"
    q25 = load_checkpoint(write_fixture(tmp_path, "qwen25_vl"), device="cpu")
    assert q25.family == "qwen2_vl" and q25.vision["kind"] == "qwen25_vl_vit"
    family, moe_cfg = llm_config_from_hf({"architectures": ["Qwen2MoeForCausalLM"], **text, "num_experts": 4,
                                          "moe_intermediate_size": 8})
    assert family == "llava_video" and moe_cfg.is_moe and moe_cfg.num_experts == 4
    with pytest.raises(NotImplementedError, match="Model not supported"):
        llm_config_from_hf({"architectures": ["GPT2LMHeadModel"], **text})
    for arch, family in (("MiniCPMV", "minicpmv"), ("LlavaLlamaModel", "nvila"),
                         ("LlavaNextVideoForConditionalGeneration", "llava_next_video")):
        assert llm_config_from_hf({"architectures": [arch], **text})[0] == family
    assert interface.get_token_type("llava_video") is tlv
    with pytest.raises(NotImplementedError, match="not supported"):
        interface.get_token_type("gpt2")


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,hd", [
    (4, 729, 16, 72), (3, 1025, 16, 64), (2, 333, 16, 80),
    (3, 17, 4, 72),  # fewer keys than one 64-key tile
    (2, 129, 4, 72),  # one row past a 128-row query block
    (2, 200, 4, 8), (2, 333, 4, 24), (1, 257, 4, 120), (1, 300, 2, 128),  # head dims at the edges
    (70, 40, 16, 64),  # B * H = 1,120 CTA rows
])
def test_cuda_bidir_kernel_matches_plain(cuda, b, n, h, hd):
    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((b, n, h, hd), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    launches = tba.bidir_attn_fwd.launches
    out = tba.flash_bidir_attention(q, k, v)
    ref = tba.bidir_attn_fwd_plain(q, k, v, hd ** -0.5)
    assert tba.bidir_attn_fwd.launches == launches + 1
    # per (row, head), relative to that row's largest output: bf16 outputs
    # and probabilities, a few ulps
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 2e-2 * ref.float().abs().amax(-1)).all()
