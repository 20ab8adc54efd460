"""PyTorch port vs the JAX package and HF transformers: the Qwen2.5-VL
family's entry points (pixels to answer, checkpoints, the whole model).

* ``TextPipeline.ask`` on raw uint8 frames through the Qwen2.5-VL tower at
  ``second_per_grid_ts`` None (1.0) and 2.0: mRoPE positions, prompt ids,
  events, cache lengths, decode base and the answer EQUAL JAX's; the spliced
  embeddings, each layer's cached keys (the kept tokens, in order) and the
  first-token logits within ``EMB_TOL`` / ``LOGIT_TOL`` of their largest
  (fp32 both sides, sums in other orders). The model's default
  ``attn_impl="auto"`` is the plain path here; the ``"flash"`` pipeline (the
  kernels' plain versions) makes the same decisions.
* ``load_checkpoint`` on ``checkpoint_fixtures.write_fixture(tmp,
  "qwen25_vl")``: the ``qwen2_vl`` family with a ``"qwen25_vl_vit"`` vision
  whose params EQUAL JAX's loaded params (fp32 and bf16: the checkpoint is
  bf16); the tower's features within ``EMB_TOL`` / ``BF16_TOL`` of JAX's;
  JAX's ``test_qwen25_vl_checkpoint_loads_and_generates`` path gives the
  same tokens, and ``TextPipeline.from_checkpoint`` JAX's answer.
* HF ``Qwen2_5_VLForConditionalGeneration`` from a random tiny config (JAX's
  tests/test_qwen2vl_vs_hf.py ``make_hf_qwen25vl``): the tower's features
  and the prefill logits on one video within ``HF_TOL`` (JAX's bounds
  against HF), the greedy tokens EQUAL.
* ``gpu``: kernels A and B at Qwen2.5-VL-72B's heads (64 / 8: query groups of
  8) with its 4 capture rows, against their plain versions.
"""

import dataclasses

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
from framefusion_tpu.models.adapters import qwen2_vl as jad
from framefusion_tpu.models.vision import qwen25_vl_vit as jvit
from framefusion_tpu.models.vision.qwen2_vl_vit import pixels_to_patches as jax_pixels_to_patches
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu_torch.config import LLMConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import qwen2_vl as tad
from framefusion_tpu_torch.models.vision import qwen25_vl_vit as tvit
from framefusion_tpu_torch.models.vision.qwen2_vl_vit import pixels_to_patches
from framefusion_tpu_torch.ops.attention import capture_rows
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.pipeline import TextPipeline
from framefusion_tpu_torch.weights import load_checkpoint, params_from_state_dict
from test_pipeline import StubTokenizer
from test_torch_qwen25vl import numpy_tower

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

EMB_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 3e-2  # a bf16 tower against JAX's fp32 one, of the largest feature
HF_TOL = 2e-4  # logits (tests/test_qwen2vl_vs_hf.py)
TOWER_HF_TOL = 3e-4  # features (tests/test_vision.py)
SECTION = (4, 6, 6)


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
    """(JAX pipeline, the port's default pipeline, the port's "flash"
    pipeline) over one tiny mRoPE LLM and Qwen2.5-VL tower (numpy weights)."""
    jcfg = jax_tiny(num_layers=4).replace(mrope_section=SECTION)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(7))
    tvcfg = tvit.tiny_qwen25vl_vit_config(out_hidden_size=jcfg.hidden_size)
    jvcfg = jvit.tiny_qwen25vl_vit_config(out_hidden_size=jcfg.hidden_size)
    tower = numpy_tower(tvcfg, seed=8, scale=0.1)
    knobs = (0.5, 0.95, 0.05)  # merges, then the prune
    jm = jax_apply(JaxModel(family="qwen2_vl", cfg=jcfg, params=jp), *knobs)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=jax.tree.map(jnp.asarray, tower),
                        vit_cfg=jvcfg)
    tcfg = tiny_llm_config(num_layers=4, mrope_section=SECTION)
    tp, tvp = tq.params_from_numpy(jax.device_get(jp), device="cpu"), tq.params_from_numpy(tower, device="cpu")
    out = [jpipe]
    for impl in ("auto", "flash"):
        tm = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=tcfg, params=tp, attn_impl=impl), *knobs)
        tm.ff = tm.ff.replace(schedule_num_layers=4)
        out.append(TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=tvp, vit_cfg=tvcfg))
    return out


@pytest.mark.parametrize("spgt", [None, 2.0])
def test_ask_on_uint8_frames_matches_jax(pipes, spgt):
    jpipe, tpipe, fpipe = pipes
    assert tpipe.model.resolved_attn_impl() == "einsum" and fpipe.model.resolved_attn_impl() == "flash"
    frames = uint8_frames(1)
    inp_j = jpipe.build_inputs("Q?", frames=frames, second_per_grid_ts=spgt)
    inp_t = tpipe.build_inputs("Q?", frames=frames, second_per_grid_ts=spgt)
    # smart_resize: 45x61 -> 56x70, grid (3, 8, 10): 20 merged patches a frame,
    # the temporal stream stepping by int(spgt or 1) * tokens_per_second 4.
    assert inp_t.position_ids.shape == (3, len(inp_t.patch_type)) and inp_t.patch_num == inp_j.patch_num == 20
    np.testing.assert_array_equal(inp_t.position_ids, inp_j.position_ids)
    start = inp_t.image_token_start
    step = int(spgt or 1.0) * 4
    assert inp_t.position_ids[0, start + 20] - inp_t.position_ids[0, start] == step
    np.testing.assert_array_equal(inp_t.patch_type, inp_j.patch_type)
    want = np.asarray(inp_j.input_embeds)
    np.testing.assert_allclose(inp_t.input_embeds.numpy(), want, atol=EMB_TOL * np.abs(want).max())

    answer = tpipe.ask("What happens?", frames=frames, second_per_grid_ts=spgt, max_new_tokens=6)
    assert answer == jpipe.ask("What happens?", frames=frames, second_per_grid_ts=spgt, max_new_tokens=6)
    res_t, res_j = tpipe.last_result, jpipe.last_result
    assert events(res_t) == events(res_j) and any(e[1] == "prune" for e in events(res_t))
    assert lens(res_t) == [int(c[2]) for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base == int(inp_t.position_ids.max()) + 1
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids
    for (k_t, _, n), (k_j, _, _) in zip(res_t.layer_caches, res_j.layer_caches):
        k_j = np.asarray(k_j)[:n]  # the kept tokens' keys, in order
        np.testing.assert_allclose(k_t[:n].numpy(), k_j, atol=LOGIT_TOL * np.abs(k_j).max())
    want = np.asarray(res_j.logits)
    np.testing.assert_allclose(res_t.logits.numpy(), want, atol=LOGIT_TOL * np.abs(want).max())
    fpipe.ask("What happens?", frames=frames, second_per_grid_ts=spgt, max_new_tokens=6)
    assert events(fpipe.last_result) == events(res_j) and lens(fpipe.last_result) == lens(res_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_checkpoint_matches_jax(tmp_path, dtype):
    path = write_fixture(tmp_path, "qwen25_vl")
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=getattr(torch, dtype), device="cpu")
    assert got.family == ref.family == "qwen2_vl" and got.cfg.mrope_section == ref.cfg.mrope_section == (2, 3, 3)
    assert got.vision["kind"] == ref.vision["kind"] == "qwen25_vl_vit"
    t_cfg, j_cfg = dataclasses.asdict(got.vision["cfg"]), dataclasses.asdict(ref.vision["cfg"])
    assert t_cfg.pop("dtype") == getattr(torch, dtype)
    j_cfg.pop("dtype")
    assert t_cfg == j_cfg and t_cfg["fullatt_block_indexes"] == (1,) and t_cfg["window_size"] == 28
    for part, t_tree, j_tree in (("llm", got.params, ref.params),
                                 ("tower", got.vision["params"], ref.vision["params"])):
        flat_t, flat_j = _flat(t_tree), _flat(jax.device_get(j_tree))
        assert flat_t.keys() == flat_j.keys(), part
        for name, t in flat_t.items():
            assert t.dtype == getattr(torch, dtype), (part, name)
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(flat_j[name], np.float32), err_msg=part + name)
    frames = np.random.default_rng(1).standard_normal((4, 28, 42, 3)).astype(np.float32)
    patches, grid = pixels_to_patches(frames, got.vision["cfg"])
    want = np.asarray(jvit.encode_video(ref.vision["params"], jnp.asarray(patches), *grid, ref.vision["cfg"],
                                        attn_impl="masked"))
    feats = tvit.encode_video(got.vision["params"], patches, *grid, got.vision["cfg"])
    tol = EMB_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(feats.float().numpy(), want, atol=tol * np.abs(want).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _embed_rows(model, n, seed=0, embed=None):
    ids = np.random.default_rng(seed).integers(0, model.cfg.vocab_size, size=n)
    return np.asarray(embed(model.params, ids), np.float32)


def test_checkpoint_generates_as_jax(tmp_path):
    """JAX's ``test_qwen25_vl_checkpoint_loads_and_generates`` path (pixels
    through the loaded tower, the adapter at second_per_grid_ts 1.0 and the
    tower's tokens_per_second, 3 greedy tokens; fp32) on both packages, then
    ``TextPipeline.from_checkpoint`` against JAX's on the fixture's own
    tokenizer."""
    path = write_fixture(tmp_path, "qwen25_vl")
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    base = rng.standard_normal((1, 28, 28, 3)).astype(np.float32)
    frames = np.concatenate([base + 0.02 * rng.standard_normal(base.shape) for _ in range(8)])
    tokens = []
    for model, pkg in ((ref, "jax"), (got, "torch")):
        ff = (jax_apply if pkg == "jax" else apply_framefusion)(model, cost=0.6, similarity_lower_bound=0.9,
                                                                ratio_lower_bound=0.05)
        ff.ff = ff.ff.replace(schedule_num_layers=model.cfg.num_layers)
        vcfg = model.vision["cfg"]
        if pkg == "jax":
            patches, grid = jax_pixels_to_patches(frames, vcfg)
            video = np.asarray(jvit.encode_video(model.vision["params"], jnp.asarray(patches), *grid, vcfg))
            text = _embed_rows(model, 8, embed=lambda p, ids: jq.embed(p, jnp.asarray(ids), model.cfg))
            adapter = jad
        else:
            patches, grid = pixels_to_patches(frames, vcfg)
            video = tvit.encode_video(model.vision["params"], patches, *grid, vcfg, attn_impl="einsum").numpy()
            text = _embed_rows(model, 8, embed=lambda p, ids: tq.embed(p, torch.from_numpy(ids)))
            adapter = tad
        inputs = adapter.build_prefill_inputs(text, video, 5, *grid, second_per_grid_ts=1.0,
                                              tokens_per_second=vcfg.tokens_per_second)
        toks, res = ff.generate(inputs, max_new_tokens=3)
        tokens.append((list(map(int, toks)), events(res)))
    assert tokens[1] == tokens[0] and len(tokens[0][0]) == 3

    jpipe = JaxPipeline.from_checkpoint(path, cost=0.8, dtype=jnp.float32)
    tpipe = TextPipeline.from_checkpoint(path, cost=0.8, dtype=torch.float32, device="cpu")
    for pipe in (jpipe, tpipe):
        pipe.model.ff = pipe.model.ff.replace(schedule_num_layers=pipe.model.cfg.num_layers)
    assert isinstance(tpipe.vit_cfg, tvit.Qwen25VLViTConfig) and tpipe.model.ff.num_importance_queries == 4
    raw = uint8_frames(2, n=4, h=30, w=30)
    assert tpipe.ask("Q?", frames=raw, max_new_tokens=5) == jpipe.ask("Q?", frames=raw, max_new_tokens=5)
    assert events(tpipe.last_result) == events(jpipe.last_result)


# -- against HF transformers ------------------------------------------------------------


VISION_START, VIDEO_TOKEN, IMAGE_TOKEN = 250, 251, 252


@pytest.fixture(scope="module")
def hf_model():
    """A random tiny HF ``Qwen2_5_VLForConditionalGeneration`` (fp32, eager
    attention) and the port's configs of its LLM and tower."""
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration

    hf_cfg = Qwen2_5_VLConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}, vision_start_token_id=VISION_START,
        video_token_id=VIDEO_TOKEN, image_token_id=IMAGE_TOKEN,
        vision_config=dict(depth=2, hidden_size=32, num_heads=2, intermediate_size=48, patch_size=7,
                           spatial_merge_size=2, window_size=28, fullatt_block_indexes=[1], out_hidden_size=64,
                           tokens_per_second=4),
        attn_implementation="eager")
    torch.manual_seed(0)
    model = Qwen2_5_VLForConditionalGeneration(hf_cfg).eval()
    cfg = LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
                    num_kv_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6, mrope_section=(2, 3, 3),
                    dtype=torch.float32)
    vcfg = tvit.Qwen25VLViTConfig(hidden_size=32, depth=2, num_heads=2, intermediate_size=48, patch_size=7,
                                  window_size=28, fullatt_block_indexes=(1,), out_hidden_size=64)
    sd = model.state_dict()
    return (model, cfg, params_from_state_dict(sd, cfg, prefix="model.language_model.", device="cpu"), vcfg,
            tvit.params_from_hf(sd, vcfg, prefix="model.visual.", device="cpu"))


def test_whole_model_matches_hf(hf_model):
    """One video (grid (2, 6, 8): ragged edge windows) in a text prompt: the
    tower's features against HF's ``visual``, the prefill logits (features
    spliced, mRoPE at second_per_grid_ts 1.0 and tokens_per_second 4)
    against HF's forward, and 6 greedy tokens through the engine's decode
    (from max(positions) + 1) against HF's ``generate``."""
    model, cfg, params, vcfg, vparams = hf_model
    frames = np.random.default_rng(4).standard_normal((4, 42, 56, 3)).astype(np.float32)
    patches, grid = pixels_to_patches(frames, vcfg)
    n_video, start = int(np.prod(grid)) // 4, 5
    rng = np.random.default_rng(5)
    ids = np.asarray(rng.integers(1, 250, size=start - 1).tolist() + [VISION_START] + [VIDEO_TOKEN] * n_video
                     + rng.integers(1, 250, size=4).tolist(), np.int64)
    thw = torch.tensor([grid])
    with torch.no_grad():
        hf_feats = model.model.visual(torch.tensor(patches), grid_thw=thw)
        hf_logits = model(input_ids=torch.tensor(ids[None]), pixel_values_videos=torch.tensor(patches),
                          video_grid_thw=thw).logits[0]
        hf_new = model.generate(input_ids=torch.tensor(ids[None]), pixel_values_videos=torch.tensor(patches),
                                video_grid_thw=thw, max_new_tokens=6, do_sample=False, pad_token_id=0)[0, len(ids):]
    feats = tvit.encode_video(vparams, patches, *grid, vcfg, attn_impl="flash")
    torch.testing.assert_close(feats, hf_feats, rtol=TOWER_HF_TOL, atol=TOWER_HF_TOL)

    # the text rows with one placeholder row at the video's place
    text = tq.embed(params, torch.from_numpy(np.concatenate([ids[:start + 1], ids[start + n_video:]])))
    inputs = tad.build_prefill_inputs(text, feats, start, *grid, second_per_grid_ts=1.0,
                                      tokens_per_second=vcfg.tokens_per_second)
    cos, sin = tq.token_cos_sin(tq.pos_tokens(inputs.position_ids, "cpu"), cfg)
    h, _, _ = tq.run_layers(params, inputs.input_embeds, cos, sin, cfg, attn_impl="einsum")
    ours = tq.final_logits(params, h, cfg)
    torch.testing.assert_close(ours, hf_logits, rtol=HF_TOL, atol=HF_TOL)

    m = FrameFusionModel(family="qwen2_vl", cfg=cfg, params=params)
    tokens, res = m.generate(inputs, max_new_tokens=6)
    assert res.decode_pos_base == int(inputs.position_ids.max()) + 1
    assert tokens == hf_new.tolist()


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_attention_and_importance_at_72b_heads(cuda, masked):
    """Kernels A and B at Qwen2.5-VL-72B's 64 query heads over 8 KV heads
    (groups of 8) with its 4 capture rows, S 4,160 (off A's 128-key tile),
    with and without dead keys: A per (row, head) within 2e-2 of that row's
    largest output, B within 1e-4 of the largest importance
    (tests/test_torch_kernels.py's bounds)."""
    s = 4160
    gen = torch.Generator(device=cuda).manual_seed(72)
    q = torch.randn((s, 64, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, 8, 128), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((s, 8, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = None
    if masked:
        kv = torch.rand((s,), generator=gen, device=cuda) > 0.45
        kv[-64:] = True  # the trailing text stays live
    out, m, l = tfp.flash_attn_fwd(q, k, v, kv)
    ref, _, _ = tfp.flash_attn_fwd_plain(q, k, v, kv)
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 2e-2 * ref.float().abs().amax(-1).clamp(min=1e-30)).all()
    rows = capture_rows(s, 4, s, kv, device=cuda)
    launches = tfp.attn_importance_rows.launches
    imp = tfp.attn_importance_rows(q, k, rows, m, l, kv)
    assert tfp.attn_importance_rows.launches == launches + 1
    imp_p = tfp.attn_importance_rows_plain(q, k, rows, m, l, kv)
    assert (imp - imp_p).abs().max() <= 1e-4 * imp_p.abs().max()
