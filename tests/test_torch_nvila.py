"""PyTorch port vs the JAX package: the NVILA family (the ``mlp_downsample``
connector on SigLIP, video and multi-image prompts) and LLaVA-NeXT-Video.

The pieces and the path end to end, on the same weights
(``params_from_numpy`` / ``projector_from_numpy``) and inputs (numpy, from
seeds):

* the adapters (video, ``temporal_pool_size`` 2, multi-image at
  ``patch_num = 1``; LLaVA-NeXT-Video's spatial ids and the reference's
  frame index): EQUAL; ``space_to_channel``: bit for bit;
* ``encode_video`` (the tower to its penultimate layer, space-to-channel,
  the fp32 LayerNorm, the two-layer GELU MLP) on both attention paths:
  ``TOWER_TOL`` of the largest feature (fp32 both sides, sums in other
  orders);
* ``load_checkpoint`` on the hub layouts of ``LlavaLlamaModel`` and
  ``LlavaNextVideoForConditionalGeneration``: EQUAL JAX's params; NVILA
  carries no tower in either package, even when its state holds
  ``vision_tower.*`` keys; LLaVA-NeXT-Video loads its SigLIP tower;
* ``TextPipeline.ask`` on uint8 frames (NVILA) and on features
  (LLaVA-NeXT-Video): embeddings within ``TOWER_TOL``, prompt ids, events,
  cache lengths and the answer EQUAL JAX's;
* the fused, planned and dense prefills and ``generate`` on a multi-image
  prompt (every token a frame), one that prunes and one whose first merge
  ratio ties the budget: events, cache lengths and tokens EQUAL JAX's,
  last-token logits within ``LOGIT_TOL`` of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import (SIGLIP_VISION_CONFIG, TINY_TEXT, _qwen2_state, _siglip_state, _write_checkpoint,
                                 write_fixture)
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FAMILIES as JAX_FAMILIES
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters import llava_next_video as jlnv
from framefusion_tpu.models.adapters import nvila as jad
from framefusion_tpu.models.vision import nvila_frontend as jnf
from framefusion_tpu.models.vision import siglip as js
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FAMILIES, FrameFusionModel, apply_framefusion, get_token_type
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import llava_next_video as tlnv
from framefusion_tpu_torch.models.adapters import nvila as tad
from framefusion_tpu_torch.models.vision import nvila_frontend as tnf
from framefusion_tpu_torch.models.vision import siglip as ts
from framefusion_tpu_torch.pipeline import DEFAULT_TEMPLATE, TextPipeline
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.weights import load_checkpoint
from test_pipeline import StubTokenizer

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOWER_TOL = 1e-5
LOGIT_TOL = 1e-4
FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def lens(res):
    return [int(c[2]) for c in res.layer_caches]


def same_inputs(got, want):
    """The port's PrefillInputs against JAX's: metadata EQUAL, embeddings
    within TOWER_TOL of the largest."""
    np.testing.assert_array_equal(got.patch_type, want.patch_type)
    np.testing.assert_array_equal(np.asarray(got.position_ids), np.asarray(want.position_ids))
    assert (got.patch_num, got.image_token_start, got.image_token_length, got.num_importance_queries) == \
           (want.patch_num, want.image_token_start, want.image_token_length, want.num_importance_queries)
    emb = got.input_embeds.numpy() if isinstance(got.input_embeds, torch.Tensor) else got.input_embeds
    ref = np.asarray(want.input_embeds)
    np.testing.assert_allclose(emb, ref, atol=TOWER_TOL * np.abs(ref).max())


def rows(seed, n, d=16):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# -- the adapters ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames,pool,n_tokens", [(8, 1, 24), (8, 2, 12), (5, 1, 5)])
def test_video_adapter_matches_jax(n_frames, pool, n_tokens):
    """Video blocks (``temporal_pool_size`` 2 halves the frames: tests/test_adapters.py's
    scenario), on numpy and on tensors: EQUAL JAX's."""
    text, video = rows(0, 10), rows(1, n_tokens)
    want = jad.build_prefill_inputs_video(text, video, 5, num_frames=n_frames, temporal_pool_size=pool)
    same_inputs(tad.build_prefill_inputs_video(text, video, 5, num_frames=n_frames, temporal_pool_size=pool), want)
    got = tad.build_prefill_inputs_video(torch.from_numpy(text), torch.from_numpy(video), 5, num_frames=n_frames,
                                         temporal_pool_size=pool)
    same_inputs(got, want)
    assert got.patch_num == n_tokens * pool // n_frames
    with pytest.raises(ValueError, match="not a multiple"):
        tad.build_prefill_inputs_video(text, rows(1, n_tokens + 1), 5, num_frames=n_frames, temporal_pool_size=pool)


def test_multi_image_adapter_matches_jax():
    """Three images of four tokens: one block at the placeholder, every token
    a frame of ``patch_num = 1``: EQUAL JAX's, as numpy and tensors."""
    imgs = [rows(9 + i, 4) for i in range(3)]
    want = jad.build_prefill_inputs_multi_image(rows(2, 9), imgs, 3)
    same_inputs(tad.build_prefill_inputs_multi_image(rows(2, 9), imgs, 3), want)
    got = tad.build_prefill_inputs_multi_image(torch.from_numpy(rows(2, 9)), [torch.from_numpy(i) for i in imgs], 3)
    same_inputs(got, want)
    assert got.patch_num == 1 and (got.patch_type[3:15] == 0).all() and got.image_token_length == 12


def test_llava_next_video_adapter_matches_jax():
    """The completed adapter (spatial ids, ``num_vit_patches / pool^2`` a
    frame) and the reference's frame index: EQUAL JAX's."""
    s = 4 + 8 * 2 + 2
    mask = np.zeros(s, bool)
    mask[4:20] = True
    np.testing.assert_array_equal(tlnv.frame_index_token_type(mask, 8), jlnv.frame_index_token_type(mask, 8))
    want = jlnv.build_prefill_inputs(rows(12, s), mask, num_vit_patches=32, pool_kernel_size=2)
    same_inputs(tlnv.build_prefill_inputs(rows(12, s), mask, num_vit_patches=32, pool_kernel_size=2), want)
    assert want.patch_num == 8
    with pytest.raises(ValueError, match="multiple"):
        tlnv.build_prefill_inputs(rows(12, s), mask, num_vit_patches=36)


def test_families_and_entry_points():
    """The three families' specs EQUAL JAX's; ``get_token_type`` gives the
    port's adapters; ``apply_framefusion`` takes each."""
    from framefusion_tpu_torch.models.adapters import minicpmv as tmc

    for fam, module in (("nvila", tad), ("llava_next_video", tlnv), ("minicpmv", tmc)):
        spec, jspec = FAMILIES[fam], JAX_FAMILIES[fam]
        for f in ("adapter_module", "llm_prefix", "num_importance_queries", "default_similarity_lower_bound",
                  "qkv_bias", "mrope"):
            assert getattr(spec, f) == getattr(jspec, f), (fam, f)
        assert get_token_type(fam) is module
        cfg = tiny_llm_config(num_layers=1)
        m = apply_framefusion(FrameFusionModel(family=fam, cfg=cfg, params={}), 0.3, 0.7, 0.1)
        assert m.ff.num_importance_queries == 1 and m.family == fam
    with pytest.raises(NotImplementedError, match="not supported"):
        get_token_type("gpt2")


# -- the connector ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape,side,pool", [((2, 16, 3), 4, 2), ((3, 36, 8), 6, 3), ((1, 1024, 1152), 32, 2)])
def test_space_to_channel_bitwise(shape, side, pool):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tnf.space_to_channel(torch.from_numpy(x), side, pool)
    want = np.asarray(jnf.space_to_channel(jnp.asarray(x), side, pool))
    assert got.shape == want.shape == (shape[0], (side // pool) ** 2, shape[2] * pool * pool)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="grid"):
        tnf.space_to_channel(torch.from_numpy(x[:, 1:]), side, pool)


def test_encode_video_matches_jax():
    """JAX's random tower and connector (LayerNorm moved off 1 / 0) through
    both packages in fp32: ``encode_video`` on each attention path within
    TOWER_TOL of the largest feature, across a frame batch boundary."""
    vcfg = js.tiny_vit_config()
    pcfg = jnf.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=48)
    vit = jax.device_get(js.init_params(vcfg, jax.random.PRNGKey(1)))
    proj = jax.device_get(jnf.init_projector(pcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    proj = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k.startswith(("ln", "b")) else v
            for k, v in proj.items()}
    tproj = tnf.projector_from_numpy(proj, device="cpu")
    assert tproj.keys() == proj.keys() and all(t.dtype == torch.float32 for t in tproj.values())
    tpcfg = tnf.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=48)
    pixels = rng.standard_normal((5, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jnf.encode_video(vit, vcfg, proj, pcfg, jnp.asarray(pixels), frame_batch=3))
    tvit = ts.params_from_numpy(vit, device="cpu")
    for impl in ("flash", "einsum"):
        got = tnf.encode_video(tvit, ts.tiny_vit_config(), tproj, tpcfg, pixels, frame_batch=3, attn_impl=impl)
        assert got.shape == want.shape == (5 * 4, 48)
        np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max(), err_msg=impl)


def test_init_projector_layout():
    """``init_projector`` draws JAX's layout from a torch Generator: the same
    keys, shapes and dtypes; LayerNorm at 1 / 0, biases 0, weights at 0.02."""
    cfg = tnf.NvilaProjectorConfig(vision_dim=8, llm_dim=12)
    jproj = jnf.init_projector(jnf.NvilaProjectorConfig(vision_dim=8, llm_dim=12), jax.random.PRNGKey(0))
    proj = tnf.init_projector(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in proj.items()} == {k: tuple(v.shape) for k, v in jproj.items()}
    assert all(v.dtype == torch.float32 for v in proj.values())
    assert (proj["ln_w"] == 1).all() and not proj["ln_b"].any() and not proj["b1"].any() and not proj["b2"].any()
    assert 0.01 < float(proj["w1"].std()) < 0.03
    again = tnf.init_projector(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(proj[k], again[k]) for k in proj)


# -- checkpoints ----------------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _assert_tree_equal(got, want, what):
    flat_t, flat_j = _flat(got), _flat(jax.device_get(want))
    assert flat_t.keys() == flat_j.keys(), what
    for name, t in flat_t.items():
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(flat_j[name], np.float32), err_msg=what + name)


def _tower_fixture(tmp_path, family):
    """A hub-layout checkpoint of ``family`` whose state also holds a SigLIP
    tower under ``vision_tower.vision_model.`` (a real NVILA state has
    such keys; LLaVA-NeXT-Video's tower lives there)."""
    rng = np.random.default_rng(5)
    if family == "nvila":
        state = _qwen2_state(rng, "llm.model.")
        config = {"architectures": ["LlavaLlamaModel"], **TINY_TEXT, "tie_word_embeddings": False,
                  "vision_config": SIGLIP_VISION_CONFIG}
    else:
        state = _qwen2_state(rng, "language_model.model.", tie=True)
        config = {"architectures": ["LlavaNextVideoForConditionalGeneration"], "vision_config": SIGLIP_VISION_CONFIG,
                  "text_config": {**TINY_TEXT, "tie_word_embeddings": True, "architectures": ["Qwen2ForCausalLM"]}}
    state.update(_siglip_state(rng, "vision_tower.vision_model."))
    return _write_checkpoint(tmp_path / f"{family}_tower", config, state)


@pytest.mark.parametrize("family,with_tower", [("nvila", False), ("nvila", True), ("llava_next_video", False),
                                               ("llava_next_video", True)])
def test_load_checkpoint_matches_jax(tmp_path, family, with_tower):
    """The hub layouts load into JAX's params (fp32 both sides: the bf16
    checkpoint exactly). NVILA's loader attaches no tower, in JAX as here,
    also when the state holds ``vision_tower.*`` keys; LLaVA-NeXT-Video
    loads the SigLIP tower it carries, EQUAL JAX's."""
    path = _tower_fixture(tmp_path, family) if with_tower else write_fixture(tmp_path, family)
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert got.family == ref.family == family and got.cfg.qkv_bias and ref.cfg.qkv_bias
    assert got.cfg.tie_word_embeddings == ref.cfg.tie_word_embeddings == (family == "llava_next_video")
    _assert_tree_equal(got.params, ref.params, "llm.")
    if family == "nvila" or not with_tower:
        assert got.vision is None and ref.vision is None
    else:
        assert got.vision["kind"] == ref.vision["kind"] == "siglip" and got.vision["projector"] is None
        for attr in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers"):
            assert getattr(got.vision["cfg"], attr) == getattr(ref.vision["cfg"], attr), attr
        _assert_tree_equal(got.vision["params"], ref.vision["params"], "tower.")


# -- the pipeline ---------------------------------------------------------------------------------


def uint8_frames(seed, n=6, h=45, w=61):
    """Camera-sized frames of one scene drifting slowly (adjacent frames alike)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    frames = [base + rng.normal(0, 2 + 12 * (i % 3), base.shape) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def nvila_pipes():
    """(JAX pipeline, the port's plain-path pipeline, the port's "flash"
    pipeline) over one tiny LLM, SigLIP tower and connector."""
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(7))
    vcfg = js.tiny_vit_config()
    vit = js.init_params(vcfg, jax.random.PRNGKey(8))
    pcfg = jnf.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=jcfg.hidden_size)
    proj = jnf.init_projector(pcfg, jax.random.PRNGKey(9))
    knobs = (0.5, 0.97, 0.05)
    jm = jax_apply(JaxModel(family="nvila", cfg=jcfg, params=jp, attn_impl="einsum"), *knobs)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": proj, "cfg": pcfg})
    tcfg = tiny_llm_config(num_layers=4)
    tp, tvit = (tq.params_from_numpy(jax.device_get(t), device="cpu") for t in (jp, vit))
    tproj = {"params": tnf.projector_from_numpy(jax.device_get(proj), device="cpu"),
             "cfg": tnf.NvilaProjectorConfig(vision_dim=vcfg.hidden_size, llm_dim=tcfg.hidden_size)}
    out = [jpipe]
    for impl in ("einsum", "flash"):
        tm = apply_framefusion(FrameFusionModel(family="nvila", cfg=tcfg, params=tp, attn_impl=impl), *knobs)
        tm.ff = tm.ff.replace(schedule_num_layers=4)
        out.append(TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=tvit, vit_cfg=ts.tiny_vit_config(),
                                projector=tproj))
    return out


def test_nvila_ask_on_uint8_frames_matches_jax(nvila_pipes):
    """Pixels to answer: SigLIP at 28 px to its penultimate layer, the
    connector's 2 x 2 tokens a frame, one block at ``<image>``: the inputs,
    prompt ids, events, cache lengths and answer EQUAL JAX's; the "flash"
    pipeline makes the same decisions; precomputed features with
    ``nvila_num_frames`` give the same answer."""
    jpipe, tpipe, fpipe = nvila_pipes
    frames = uint8_frames(0)
    inp_j, inp_t = jpipe.build_inputs("Q?", frames=frames), tpipe.build_inputs("Q?", frames=frames)
    same_inputs(inp_t, inp_j)
    assert inp_t.patch_num == 4 and inp_t.image_token_length == 6 * 4
    before = DEFAULT_TEMPLATE.format(question="Q?").partition("<image>")
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids == (StubTokenizer().encode(before[0])
                                                              + StubTokenizer().encode(before[2]))
    answer = tpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert answer == jpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    res_t, res_j = tpipe.last_result, jpipe.last_result
    assert events(res_t) == events(res_j) and any(e[1] == "merge" and e[2] for e in events(res_t))
    assert lens(res_t) == lens(res_j)
    fpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert events(fpipe.last_result) == events(res_j) and lens(fpipe.last_result) == lens(res_t)
    feats = tnf.encode_video(tpipe.vit_params, tpipe.vit_cfg, tpipe.projector["params"], tpipe.projector["cfg"],
                             tpipe._prepare_frames(frames), attn_impl="einsum")
    with pytest.raises(ValueError, match="nvila_num_frames"):
        tpipe.ask("Q?", video_features=feats)
    tpipe.nvila_num_frames = 6
    try:
        assert tpipe.ask("What happens?", video_features=feats, max_new_tokens=6) == answer
    finally:
        del tpipe.nvila_num_frames
    with pytest.raises(ValueError, match="connector"):
        TextPipeline(model=tpipe.model, tokenizer=StubTokenizer(), vit_params=tpipe.vit_params,
                     vit_cfg=tpipe.vit_cfg).ask("Q?", frames=frames)


def test_llava_next_video_ask_matches_jax():
    """LLaVA-NeXT-Video through the LLaVA prompt (one ``<image>`` block of
    precomputed 2 x 3 + newline features a frame): the answer, prompt ids,
    events and cache lengths EQUAL JAX's."""
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(3))
    jm = jax_apply(JaxModel(family="llava_next_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.5, 0.8, 0.05)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    tm = apply_framefusion(FrameFusionModel(family="llava_next_video", cfg=tiny_llm_config(num_layers=4),
                                            params=tq.params_from_numpy(jax.device_get(jp), device="cpu"),
                                            attn_impl="einsum"), 0.5, 0.8, 0.05)
    tm.ff = tm.ff.replace(schedule_num_layers=4)
    assert tm.ff.similarity_lower_bound == 0.8
    vcfg = js.tiny_vit_config()  # 4 patches a side -> 2 x (2 + 1) = 6 tokens a frame
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_cfg=vcfg)
    tpipe = TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_cfg=ts.tiny_vit_config())
    rng = np.random.default_rng(4)
    base = rng.standard_normal((6, jcfg.hidden_size)).astype(np.float32)
    feats = np.concatenate([base + 0.05 * rng.standard_normal(base.shape).astype(np.float32) for _ in range(5)])
    answer = tpipe.ask("Q?", video_features=feats, max_new_tokens=6)
    assert answer == jpipe.ask("Q?", video_features=feats, max_new_tokens=6)
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids
    assert events(tpipe.last_result) == events(jpipe.last_result) and len(events(tpipe.last_result)) >= 1
    assert lens(tpipe.last_result) == lens(jpipe.last_result)


# -- the engine on a multi-image prompt ------------------------------------------------------------


def multi_image_prompt(seed, hidden, n_images=6, per_image=5, n_pre=5, n_post=7, coherent=0.4):
    """(text embeds with one placeholder row, image list) at embedding scale
    0.05: a ``coherent`` share of the tokens resemble the token before them
    (scales that spread the similarities), the rest are new."""
    rng = np.random.default_rng(seed)
    toks, prev = [], rng.standard_normal(hidden)
    for _ in range(n_images * per_image):
        new = rng.standard_normal(hidden)
        prev = prev + rng.uniform(0.05, 0.5) * new if rng.random() < coherent else new
        toks.append(prev)
    toks = (np.stack(toks) * 0.05).astype(np.float32)
    text = (rng.standard_normal((n_pre + 1 + n_post, hidden)) * 0.05).astype(np.float32)
    return text, [toks[i * per_image:(i + 1) * per_image] for i in range(n_images)], n_pre


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(13))
    return jcfg, tiny_llm_config(num_layers=4), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


# (seed, coherent share): "prunes" merges at layer -1 and prunes at layer 1;
# "tie" merges 18 of 30 tokens at layer -1, a ratio of exactly 0.6 against
# cost 0.4's budget of f32(0.6): JAX's fused executor with its layer -1
# merge compacted first (``compact_pre_event=True``; the port's fused
# executor always compacts it) decides that merge in float64 on the host (a
# merge), its planned one in fp32 on the device (capped at the budget), and
# the port's executors must do as each does. JAX's default "auto" picks the
# compaction by a timed host read, so the tests pin it.
SCENARIOS = {"prunes": (1, 0.4), "tie": (1, 0.6)}


@pytest.mark.parametrize("mode,scenario", [("fused", "prunes"), ("planned", "prunes"), ("dense", "prunes"),
                                           ("fused", "tie"), ("planned", "tie")])
def test_multi_image_prefill_and_generate_match_jax(stacks, mode, scenario):
    """``patch_num = 1``: the merge compares each token with the one before
    it across the whole span. Each executor: events, cache lengths and the
    live rows' layer-0 keys EQUAL JAX's / to tolerance, logits to
    tolerance, then 6 greedy tokens EQUAL JAX's; the "flash" engine (the
    kernels' plain versions) makes the same decisions."""
    jcfg, tcfg, jp, tp = stacks
    seed, coherent = SCENARIOS[scenario]
    text, imgs, pos = multi_image_prompt(seed, tcfg.hidden_size, coherent=coherent)
    inp_j = jad.build_prefill_inputs_multi_image(text, imgs, pos)
    inp_t = tad.build_prefill_inputs_multi_image(text, imgs, pos)
    args = [(i.input_embeds, i.patch_type, i.position_ids, i.patch_num, i.image_token_start, i.image_token_length)
            for i in (inp_j, inp_t)]
    eng_j = JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum", compact_pre_event=True)
    res_j = eng_j.prefill(*args[0], mode=mode)
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum")
    res_t = eng_t.prefill(*args[1], mode=mode)
    assert res_t.mode == res_j.mode and res_t.valid_len == res_j.valid_len and lens(res_t) == lens(res_j)
    if mode != "dense":
        assert events(res_t) == events(res_j)
        kinds = [e[1] for e in events(res_t)]
        if scenario == "prunes":
            assert kinds[0] == "merge" and events(res_t)[0][2] and "prune" in kinds
        else:
            assert events(res_t)[0][2] == 18 and kinds[0] == ("merge" if mode == "fused" else "merge_capped")
    n0 = lens(res_t)[0]
    k_j = np.asarray(res_j.layer_caches[0][0])[:n0]
    np.testing.assert_allclose(res_t.layer_caches[0][0][:n0].numpy(), k_j, atol=LOGIT_TOL * np.abs(k_j).max())
    want = np.asarray(res_j.logits)
    np.testing.assert_allclose(res_t.logits.numpy(), want, atol=LOGIT_TOL * np.abs(want).max())
    assert eng_t.generate(res_t, 6) == eng_j.generate_greedy(res_j, 6)
    res_f = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF)).prefill(*args[1], mode=mode)
    assert lens(res_f) == lens(res_t) and (mode == "dense" or events(res_f) == events(res_t))


def test_multi_image_through_the_model_matches_jax(stacks):
    """The model's entry point on the family: ``apply_framefusion`` then
    ``generate`` on the multi-image prompt, as a user calls it: tokens and
    events EQUAL JAX's."""
    jcfg, tcfg, jp, tp = stacks
    text, imgs, pos = multi_image_prompt(2, tcfg.hidden_size, n_images=4, per_image=7)
    jm = jax_apply(JaxModel(family="nvila", cfg=jcfg, params=jp, attn_impl="einsum"), 0.4, 0.75, 0.05)
    tm = apply_framefusion(FrameFusionModel(family="nvila", cfg=tcfg, params=tp, attn_impl="einsum"), 0.4, 0.75, 0.05)
    for m in (jm, tm):
        m.ff = m.ff.replace(schedule_num_layers=4, bucket=32)
    toks_j, res_j = jm.generate(jad.build_prefill_inputs_multi_image(text, imgs, pos), max_new_tokens=5)
    toks_t, res_t = tm.generate(tad.build_prefill_inputs_multi_image(text, imgs, pos), max_new_tokens=5)
    assert toks_t == toks_j and events(res_t) == events(res_j) and lens(res_t) == lens(res_j)
    assert any(e[2] for e in events(res_t))
