"""PyTorch port vs the JAX package and HF transformers: the InternVL
family's entry points (pixels to answer, checkpoints).

* ``TextPipeline.ask`` on raw uint8 frames (resized to the tower's 28 x 28,
  ImageNet statistics, InternViT, the pixel shuffle, ``mlp1``, one
  ``FrameN: <image>`` line a frame): the spliced embeddings within
  ``EMB_TOL`` of JAX's (the same fp32 tower, sums in other orders); patch
  types, the span, prompt ids, events, cache lengths and the answer EQUAL
  JAX's on the plain path; the ``"flash"`` pipeline (the kernels' plain
  versions) makes the same decisions.
* ``load_checkpoint`` on ``checkpoint_fixtures.write_fixture(tmp,
  "internvl")`` (``InternVLChatModel``: InternLM2's fused ``wqkv`` at g = 2,
  Hk = 2, the hub layout's InternViT and ``mlp1``): the LLM, tower and
  projector params EQUAL JAX's loaded params (the checkpoint is bf16: the
  port loads the tower in fp32 or bf16 as asked, JAX keeps fp32, both
  exact); the features within ``EMB_TOL`` of JAX's at fp32 and ``BF16_TOL``
  at bf16; a partial tower falls back to an LLM-only load, as JAX's does;
  ``TextPipeline.from_checkpoint`` gives JAX's answer.
* HF ``InternVLModel`` from a random tiny config with qk norm off and on:
  its vision tower's last hidden state (``InternVLVisionModel``) against
  ``encode`` on both attention paths, and ``get_image_features`` against
  ``extract_features``, within 3e-4 (tests/test_vision.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import write_fixture
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.vision import internvl_vit as jvit
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu.weights import _load_vision as jax_load_vision
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu.weights import load_state as jax_load_state
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.vision import internvl_vit as tvit
from framefusion_tpu_torch.pipeline import INTERNVL_TEMPLATE, TextPipeline
from framefusion_tpu_torch.weights import _load_vision, llm_config_from_hf, load_checkpoint, load_state
from test_pipeline import StubTokenizer

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

EMB_TOL = 1e-5
BF16_TOL = 3e-2  # a bf16 tower against JAX's fp32 one, of the largest feature
HF_TOL = 3e-4
GQA = dict(num_layers=4, num_heads=8, num_kv_heads=2, qkv_bias=False)


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def lens(res):
    return [int(c[2]) for c in res.layer_caches]


def uint8_frames(seed, n=6, h=45, w=61):
    """Camera-sized frames of one scene drifting slowly (adjacent frames alike)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    frames = [base + rng.normal(0, 2 + 12 * (i % 3), base.shape) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, the port's plain-path pipeline, the port's "flash"
    pipeline) over one tiny no-bias Hq 8 / Hk 2 LLM and InternViT with qkv
    bias."""
    jcfg = jax_tiny(**GQA)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(7))
    vcfg = jvit.tiny_internvit_config(attention_bias=True, text_hidden_size=jcfg.hidden_size)
    vit, proj = jvit.init_params(vcfg, jax.random.PRNGKey(8)), jvit.init_projector(vcfg, jax.random.PRNGKey(9))
    knobs = (0.5, 0.97, 0.05)  # a merge at layer -1, then the prune
    jm = jax_apply(JaxModel(family="internvl", cfg=jcfg, params=jp, attn_impl="einsum"), *knobs)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    tcfg = tiny_llm_config(**GQA)
    tp, tvp, tproj = (tq.params_from_numpy(jax.device_get(t), device="cpu") for t in (jp, vit, proj))
    tvcfg = tvit.tiny_internvit_config(attention_bias=True, text_hidden_size=tcfg.hidden_size)
    out = [jpipe]
    for impl in ("einsum", "flash"):
        tm = apply_framefusion(FrameFusionModel(family="internvl", cfg=tcfg, params=tp, attn_impl=impl), *knobs)
        tm.ff = tm.ff.replace(schedule_num_layers=4)
        out.append(TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=tvp, vit_cfg=tvcfg,
                                projector=tproj))
    return out


def test_ask_on_uint8_frames_matches_jax(pipes):
    jpipe, tpipe, fpipe = pipes
    frames = uint8_frames(0)
    inp_j, inp_t = jpipe.build_inputs("Q?", frames=frames), tpipe.build_inputs("Q?", frames=frames)
    np.testing.assert_array_equal(inp_t.patch_type, inp_j.patch_type)
    np.testing.assert_array_equal(inp_t.position_ids, np.asarray(inp_j.position_ids))
    assert (inp_t.patch_num, inp_t.image_token_start, inp_t.image_token_length, inp_t.num_importance_queries) == \
           (inp_j.patch_num, inp_j.image_token_start, inp_j.image_token_length, 1)
    assert inp_t.patch_num == 4 and (inp_t.patch_type >= 0).sum() == 6 * 4
    span = inp_t.patch_type[inp_t.image_token_start:inp_t.image_token_start + inp_t.image_token_length]
    assert (span < 0).any(), "the text between frames lies inside the span (the reference's quirk)"
    want = np.asarray(inp_j.input_embeds)
    np.testing.assert_allclose(inp_t.input_embeds.numpy(), want, atol=EMB_TOL * np.abs(want).max())
    prefix = "".join(f"Frame{i + 1}: <image>\n" for i in range(6))
    segments = INTERNVL_TEMPLATE.format(video_prefix=prefix, question="Q?").split("<image>")
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids == [i for s in segments for i in StubTokenizer().encode(s)]

    answer = tpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert answer == jpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    res_t, res_j = tpipe.last_result, jpipe.last_result
    assert events(res_t) == events(res_j) and any(e[1] == "prune" for e in events(res_t))
    assert lens(res_t) == lens(res_j)
    fpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert events(fpipe.last_result) == events(res_j) and lens(fpipe.last_result) == lens(res_t)
    feats = tvit.extract_features(tpipe.vit_params, tpipe.projector, tpipe._prepare_frames(frames), tpipe.vit_cfg,
                                  attn_impl="einsum")
    assert tpipe.ask("What happens?", video_features=feats, max_new_tokens=6) == answer
    with pytest.raises(ValueError, match="n_frames, tokens_per_frame"):
        tpipe.ask("Q?", video_features=feats.reshape(-1, feats.shape[-1]))
    with pytest.raises(ValueError, match="InternViT"):
        TextPipeline(model=tpipe.model, tokenizer=StubTokenizer()).ask("Q?", frames=frames.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_checkpoint_matches_jax(tmp_path, dtype):
    path = write_fixture(tmp_path, "internvl")
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=getattr(torch, dtype), device="cpu")
    assert got.family == ref.family == "internvl" and got.cfg.qkv_bias is ref.cfg.qkv_bias is False
    assert (got.cfg.num_heads, got.cfg.num_kv_heads) == (ref.cfg.num_heads, ref.cfg.num_kv_heads) == (4, 2)
    assert got.vision["kind"] == ref.vision["kind"] == "internvl_vit"
    for attr in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                 "attention_bias", "use_qk_norm", "text_hidden_size", "downsample_ratio"):
        assert getattr(got.vision["cfg"], attr) == getattr(ref.vision["cfg"], attr), attr
    want_dt = getattr(torch, dtype)
    for part, t_tree, j_tree in (("llm", got.params, ref.params), ("tower", got.vision["params"], ref.vision["params"]),
                                 ("projector", got.vision["projector"], ref.vision["projector"])):
        flat_t, flat_j = _flat(t_tree), _flat(jax.device_get(j_tree))
        assert flat_t.keys() == flat_j.keys(), part
        for name, t in flat_t.items():
            assert t.dtype == want_dt, (part, name)
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(flat_j[name], np.float32), err_msg=part + name)
    pixels = np.random.default_rng(1).standard_normal((3, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jvit.extract_features(ref.vision["params"], ref.vision["projector"], jnp.asarray(pixels),
                                            ref.vision["cfg"]))
    feats = tvit.extract_features(got.vision["params"], got.vision["projector"], pixels, got.vision["cfg"])
    tol = EMB_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(feats.float().numpy(), want, atol=tol * np.abs(want).max())

    # A tower without its projector: an LLM-only load, as JAX's loader falls back.
    import json

    with open(f"{path}/config.json") as f:
        cfg_dict = json.load(f)
    family, llm_cfg = llm_config_from_hf(cfg_dict)
    partial = {k: v for k, v in load_state(path).items() if not k.startswith("mlp1.")}
    assert family == "internvl" and not llm_cfg.qkv_bias
    assert _load_vision(family, partial, cfg_dict, llm_cfg, "cpu") is None
    j_partial = {k: v for k, v in jax_load_state(path).items() if not k.startswith("mlp1.")}
    assert jax_load_vision(family, j_partial, cfg_dict, ref.cfg) is None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_from_checkpoint_matches_jax(tmp_path):
    path = write_fixture(tmp_path, "internvl")
    jpipe = JaxPipeline.from_checkpoint(path, cost=0.6, dtype=jnp.float32, tokenizer=StubTokenizer())
    tpipe = TextPipeline.from_checkpoint(path, cost=0.6, dtype=torch.float32, tokenizer=StubTokenizer(),
                                         device="cpu")
    for pipe in (jpipe, tpipe):
        pipe.model.ff = pipe.model.ff.replace(schedule_num_layers=pipe.model.cfg.num_layers)
    tpipe.model = tpipe.model.__class__(**{**vars(tpipe.model), "attn_impl": "einsum", "_engine": None})
    assert tpipe.model.family == "internvl" and tpipe.model.ff.similarity_lower_bound == 0.5
    assert tpipe.model.ff.num_importance_queries == 1
    frames = uint8_frames(2, n=4, h=30, w=30)
    assert tpipe.ask("Q?", frames=frames, max_new_tokens=5) == jpipe.ask("Q?", frames=frames, max_new_tokens=5)
    assert events(tpipe.last_result) == events(jpipe.last_result)
    assert lens(tpipe.last_result) == lens(jpipe.last_result)


# -- against HF transformers ------------------------------------------------------------


@pytest.mark.parametrize("qk_norm", [False, True])
def test_tower_and_features_match_hf(qk_norm):
    """A tiny HF ``InternVLModel`` (qkv bias on, qk norm as given): its
    ``vision_tower`` against ``encode`` on each attention path, its
    ``get_image_features`` against ``extract_features``."""
    from transformers import InternVLConfig, InternVLModel

    cfg_hf = InternVLConfig(
        vision_config=dict(image_size=[28, 28], patch_size=[7, 7], hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4, attention_bias=True, use_qk_norm=qk_norm),
        text_config=dict(model_type="qwen2", vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2),
        downsample_ratio=0.5)
    cfg_hf.vision_config._attn_implementation = "eager"
    torch.manual_seed(1)
    model = InternVLModel(cfg_hf).eval()
    with torch.no_grad():  # move the layer scales and norms off their constants
        for name, p in model.vision_tower.named_parameters():
            if "lambda" in name or "norm" in name:
                p.add_(torch.randn_like(p) * 0.1)
    cfg = tvit.tiny_internvit_config(attention_bias=True, use_qk_norm=qk_norm)
    sd = model.state_dict()
    vit = tvit.params_from_hf(sd, cfg, prefix="vision_tower.", device="cpu")
    proj = tvit.projector_from_hf(sd, cfg, prefix="multi_modal_projector.", device="cpu")
    pixels = np.random.default_rng(0).standard_normal((3, 28, 28, 3)).astype(np.float32)
    px = torch.tensor(pixels.transpose(0, 3, 1, 2))
    with torch.no_grad():
        hidden = model.vision_tower(px).last_hidden_state
        feats = model.get_image_features(px, vision_feature_layer=-1, vision_feature_select_strategy="default")
    for impl in ("flash", "einsum"):
        torch.testing.assert_close(tvit.encode(vit, pixels, cfg, attn_impl=impl), hidden, rtol=HF_TOL, atol=HF_TOL)
    got = tvit.extract_features(vit, proj, pixels, cfg)
    assert got.shape == (3, cfg.tokens_per_image, cfg.text_hidden_size)
    torch.testing.assert_close(got, feats, rtol=HF_TOL, atol=HF_TOL)
