"""PyTorch port vs the JAX package and HF transformers: the Qwen2-VL
family's entry points (pixels to answer, checkpoints) and the card.

* ``TextPipeline.ask`` on raw uint8 frames (``smart_resize`` at factor
  patch * merge, the tower, the ``<|video_pad|>`` splice, mRoPE ids): the
  spliced embeddings within ``EMB_TOL`` of JAX's (the same fp32 tower, sums
  in other orders); position ids, prompt ids, events, cache lengths, decode
  base and the answer EQUAL JAX's on the plain path; the ``"flash"``
  pipeline (the kernels' plain versions) makes the same decisions.
* ``load_checkpoint`` on ``checkpoint_fixtures.write_fixture(tmp,
  "qwen2_vl")``: the LLM and tower params EQUAL JAX's loaded params (the
  checkpoint is bf16: the port loads the tower in fp32 or bf16 as asked,
  JAX keeps fp32, both exact); the tower's features within ``EMB_TOL`` of
  JAX's at fp32 and ``BF16_TOL`` at bf16; ``TextPipeline.from_checkpoint``
  gives JAX's answer. A Qwen2.5-VL checkpoint loads with its own tower.
* HF ``Qwen2VLForConditionalGeneration`` from a random tiny config (the
  pattern of tests/test_qwen2vl_vs_hf.py): prefill logits within 2e-4
  (that file's bound), greedy tokens EQUAL; the tower against HF's vision
  model within 2e-4 (tests/test_vision.py's bound).
* ``gpu``: kernel E at the Qwen2-VL-7B tower's shape (32, 884, 16, 80) and
  kernel B at 4 capture rows (Hq 28) at a phase length of the 7,072-token
  video prompt against their plain versions.
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
from framefusion_tpu.models.vision import qwen2_vl_vit as jvit
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu_torch.config import LLMConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters.qwen2_vl import mrope_position_ids
from framefusion_tpu_torch.models.vision import qwen2_vl_vit as tvit
from framefusion_tpu_torch.ops.attention import capture_rows
from framefusion_tpu_torch.ops.kernels import bidir_attention as tba
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.pipeline import QWEN2_VL_TEMPLATE, TextPipeline
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.weights import load_checkpoint, params_from_state_dict
from test_pipeline import StubTokenizer

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

EMB_TOL = 1e-5
BF16_TOL = 3e-2  # a bf16 tower against JAX's fp32 one, of the largest feature
HF_TOL = 2e-4
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
    """(JAX pipeline, the port's plain-path pipeline, the port's "flash"
    pipeline) over one tiny mRoPE LLM and Qwen2-VL tower."""
    jcfg = jax_tiny(num_layers=4).replace(mrope_section=SECTION)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(5))
    vcfg = jvit.tiny_qwen2vl_vit_config(hidden_size=jcfg.hidden_size)
    vit = jvit.init_params(vcfg, jax.random.PRNGKey(6))
    knobs = (0.5, 0.95, 0.05)  # merges at three layers, then the prune
    jm = jax_apply(JaxModel(family="qwen2_vl", cfg=jcfg, params=jp, attn_impl="einsum"), *knobs)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg)
    tcfg = tiny_llm_config(num_layers=4, mrope_section=SECTION)
    tp, tvp = (tq.params_from_numpy(jax.device_get(t), device="cpu") for t in (jp, vit))
    tvcfg = tvit.tiny_qwen2vl_vit_config(hidden_size=tcfg.hidden_size)
    out = [jpipe]
    for impl in ("einsum", "flash"):
        tm = apply_framefusion(FrameFusionModel(family="qwen2_vl", cfg=tcfg, params=tp, attn_impl=impl), *knobs)
        tm.ff = tm.ff.replace(schedule_num_layers=4)
        out.append(TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=tvp, vit_cfg=tvcfg))
    return out


def test_ask_on_uint8_frames_matches_jax(pipes):
    jpipe, tpipe, fpipe = pipes
    frames = uint8_frames(0)
    inp_j, inp_t = jpipe.build_inputs("Q?", frames=frames), tpipe.build_inputs("Q?", frames=frames)
    assert inp_t.position_ids.shape == (3, len(inp_t.patch_type)) and inp_t.patch_num == inp_j.patch_num == 20
    # smart_resize: 45x61 -> 56x70 (min_pixels), grid (3, 8, 10), 20 merged patches a frame
    np.testing.assert_array_equal(inp_t.position_ids, inp_j.position_ids)
    np.testing.assert_array_equal(inp_t.patch_type, inp_j.patch_type)
    assert (inp_t.image_token_start, inp_t.image_token_length, inp_t.num_importance_queries) == \
           (inp_j.image_token_start, inp_j.image_token_length, 4)
    want = np.asarray(inp_j.input_embeds)
    np.testing.assert_allclose(inp_t.input_embeds.numpy(), want, atol=EMB_TOL * np.abs(want).max())
    before, _, after = QWEN2_VL_TEMPLATE.format(question="Q?").partition("<|video_pad|>")
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids == StubTokenizer().encode(before) + \
        StubTokenizer().encode(after)

    answer = tpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert answer == jpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    res_t, res_j = tpipe.last_result, jpipe.last_result
    assert events(res_t) == events(res_j) and any(e[1] == "prune" for e in events(res_t))
    assert lens(res_t) == [int(c[2]) for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base == int(inp_t.position_ids.max()) + 1
    fpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert events(fpipe.last_result) == events(res_j) and lens(fpipe.last_result) == lens(res_t)
    patches, grid = tvit.pixels_to_patches(tpipe._prepare_frames(frames), tpipe.vit_cfg)
    feats = tvit.encode_video(tpipe.vit_params, patches, *grid, tpipe.vit_cfg, attn_impl="einsum")
    assert tpipe.ask("What happens?", video_features=feats, video_grid_thw=grid, max_new_tokens=6) == answer
    with pytest.raises(ValueError, match="video_grid_thw"):
        tpipe.ask("Q?", video_features=feats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_checkpoint_matches_jax(tmp_path, dtype):
    path = write_fixture(tmp_path, "qwen2_vl")
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=getattr(torch, dtype), device="cpu")
    assert got.family == ref.family == "qwen2_vl" and got.cfg.mrope_section == ref.cfg.mrope_section == (2, 3, 3)
    assert got.vision["kind"] == ref.vision["kind"] == "qwen2_vl_vit"
    for attr in ("embed_dim", "depth", "num_heads", "patch_size", "temporal_patch_size", "spatial_merge_size",
                 "mlp_ratio", "hidden_size"):
        assert getattr(got.vision["cfg"], attr) == getattr(ref.vision["cfg"], attr), attr
    want_dt = getattr(torch, dtype)
    for part, t_tree, j_tree in (("llm", got.params, ref.params), ("tower", got.vision["params"], ref.vision["params"])):
        flat_t, flat_j = _flat(t_tree), _flat(jax.device_get(j_tree))
        assert flat_t.keys() == flat_j.keys(), part
        for name, t in flat_t.items():
            assert t.dtype == want_dt, (part, name)
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(flat_j[name], np.float32), err_msg=part + name)
    frames = np.random.default_rng(1).standard_normal((4, 28, 28, 3)).astype(np.float32)
    patches, grid = jvit.pixels_to_patches(frames, ref.vision["cfg"])
    want = np.asarray(jvit.encode_video(ref.vision["params"], jnp.asarray(patches), *grid, ref.vision["cfg"],
                                        attn_impl="einsum"))
    feats = tvit.encode_video(got.vision["params"], patches, *grid, got.vision["cfg"])
    tol = EMB_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(feats.float().numpy(), want, atol=tol * np.abs(want).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_from_checkpoint_matches_jax_and_qwen25_is_refused(tmp_path):
    path = write_fixture(tmp_path, "qwen2_vl")
    jpipe = JaxPipeline.from_checkpoint(path, cost=0.8, dtype=jnp.float32)
    tpipe = TextPipeline.from_checkpoint(path, cost=0.8, dtype=torch.float32, device="cpu")
    for pipe in (jpipe, tpipe):
        pipe.model.ff = pipe.model.ff.replace(schedule_num_layers=pipe.model.cfg.num_layers)
    tpipe.model = dataclasses.replace(tpipe.model, attn_impl="einsum")  # the plain path: fp32, as JAX's
    assert tpipe.model.family == "qwen2_vl" and tpipe.model.ff.similarity_lower_bound == 0.5
    assert tpipe.model.ff.num_importance_queries == 4
    frames = uint8_frames(2, n=4, h=30, w=30)
    assert tpipe.ask("Q?", frames=frames, max_new_tokens=5) == jpipe.ask("Q?", frames=frames, max_new_tokens=5)
    assert events(tpipe.last_result) == events(jpipe.last_result)
    # Qwen2.5-VL, once refused here, now loads: the qwen2_vl family with its
    # own tower (tests/test_torch_qwen25vl_io.py holds it against JAX).
    q25 = load_checkpoint(write_fixture(tmp_path / "q25", "qwen25_vl"), device="cpu")
    assert q25.family == "qwen2_vl" and q25.vision["kind"] == "qwen25_vl_vit"
    assert q25.vision["cfg"].tokens_per_second == 4 and q25.vision["cfg"].out_hidden_size == q25.cfg.hidden_size


# -- against HF transformers ------------------------------------------------------------


VISION_START, VIDEO_TOKEN, IMAGE_TOKEN = 250, 251, 252


@pytest.fixture(scope="module")
def hf_model():
    """A random tiny HF ``Qwen2VLForConditionalGeneration`` (fp32, eager
    attention) and the port's mRoPE config of its LLM."""
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    hf_cfg = Qwen2VLConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        vision_start_token_id=VISION_START, video_token_id=VIDEO_TOKEN, image_token_id=IMAGE_TOKEN,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=64, num_heads=2, patch_size=14,
                           spatial_merge_size=2, temporal_patch_size=2, mlp_ratio=2),
        attn_implementation="eager")
    torch.manual_seed(0)
    model = Qwen2VLForConditionalGeneration(hf_cfg).eval()
    cfg = LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4,
                    num_kv_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6, mrope_section=(2, 3, 3),
                    dtype=torch.float32)
    return model, cfg, params_from_state_dict(model.state_dict(), cfg, prefix="model.language_model.", device="cpu")


def video_prompt_ids(rng, video_start, n_video, n_tail):
    lead = rng.integers(1, 250, size=video_start - 1).tolist() + [VISION_START]
    return np.asarray(lead + [VIDEO_TOKEN] * n_video + rng.integers(1, 250, size=n_tail).tolist(), np.int64)


def test_mrope_stack_matches_hf(hf_model):
    """Prefill logits with distinct (t, h, w) streams, and a greedy decode
    through the engine (decode base max(positions) + 1, HF's
    ``cache_position + rope_deltas``)."""
    model, cfg, params = hf_model
    rng = np.random.default_rng(0)
    grid_t, grid_h, grid_w, start, n_tail = 3, 4, 8, 4, 3
    ids = video_prompt_ids(rng, start, grid_t * (grid_h // 2) * (grid_w // 2), n_tail)
    grid = torch.tensor([[grid_t, grid_h, grid_w]])
    pos3 = mrope_position_ids(len(ids), start, grid_t, grid_h, grid_w)
    with torch.no_grad():
        hf_logits = model(input_ids=torch.tensor(ids[None]), video_grid_thw=grid).logits[0]
        hf_new = model.generate(input_ids=torch.tensor(ids[None]), video_grid_thw=grid, max_new_tokens=8,
                                do_sample=False, pad_token_id=0)[0, len(ids):]
    embeds = tq.embed(params, torch.from_numpy(ids))
    cos, sin = tq.token_cos_sin(tq.pos_tokens(pos3, "cpu"), cfg)
    h, _, _ = tq.run_layers(params, embeds, cos, sin, cfg, attn_impl="einsum")
    ours = tq.final_logits(params, h, cfg)
    torch.testing.assert_close(ours, hf_logits, rtol=HF_TOL, atol=HF_TOL)
    assert torch.equal(ours.argmax(-1), hf_logits.argmax(-1))
    from framefusion_tpu_torch.config import FrameFusionConfig

    engine = CompressionEngine(params, cfg, FrameFusionConfig(bucket=32, num_importance_queries=4),
                               attn_impl="einsum")
    res = engine.dense_prefill(embeds, pos3)
    assert res.decode_pos_base == int(pos3.max()) + 1
    assert engine.generate(res, 8) == hf_new.tolist()


def test_tower_matches_hf():
    from transformers import Qwen2VLConfig
    from transformers.models.qwen2_vl.modeling_qwen2_vl import Qwen2VisionTransformerPretrainedModel

    vc = Qwen2VLConfig(vision_config=dict(depth=2, embed_dim=64, num_heads=4, patch_size=7, temporal_patch_size=2,
                                          spatial_merge_size=2, mlp_ratio=2, hidden_size=32, in_channels=3)).vision_config
    vc._attn_implementation = "eager"
    torch.manual_seed(0)
    tower = Qwen2VisionTransformerPretrainedModel._from_config(vc).eval()
    cfg = tvit.tiny_qwen2vl_vit_config()
    params = tvit.params_from_hf(tower.state_dict(), cfg, prefix="", device="cpu")
    frames = np.random.default_rng(1).standard_normal((5, 28, 56, 3)).astype(np.float32)
    patches, grid = tvit.pixels_to_patches(frames, cfg)
    with torch.no_grad():
        want = tower(torch.tensor(patches), grid_thw=torch.tensor([grid]))
    for impl in ("flash", "einsum"):
        torch.testing.assert_close(tvit.encode_video(params, patches, *grid, cfg, attn_impl=impl), want,
                                   rtol=HF_TOL, atol=HF_TOL)


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_bidir_kernel_at_qwen2vl_tower_shape(cuda):
    """Kernel E at (B 32, N 884, H 16, hd 80): N off its key tile, head dim
    80 zero-filled to 96 in shared memory; per (row, head) within 2e-2 of
    that row's largest output (tests/test_torch_vision.py's bound)."""
    gen = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = (torch.randn((32, 884, 16, 80), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    launches = tba.bidir_attn_fwd.launches
    out = tba.flash_bidir_attention(q, k, v)
    assert tba.bidir_attn_fwd.launches == launches + 1
    ref = tba.bidir_attn_fwd_plain(q, k, v, 80 ** -0.5)
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 2e-2 * ref.float().abs().amax(-1)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_importance_at_four_rows(cuda, masked):
    """Kernel B with Qwen2-VL's 4 capture rows at Hq 28 / Hk 4, S 6,784 (a
    phase length of the 7,072-token prompt), with and without dead keys:
    1e-4 of the largest importance (tests/test_torch_kernels.py's bound)."""
    s = 6784
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((s, 28, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((s, 4, 128), generator=gen, device=cuda).to(torch.bfloat16)
    kv = None
    if masked:
        kv = torch.rand((s,), generator=gen, device=cuda) > 0.45
        kv[-64:] = True  # the trailing text stays live
    _, m, l = tfp.flash_attn_fwd(q, k, k, kv)
    rows = capture_rows(s, 4, s, kv, device=cuda)
    launches = tfp.attn_importance_rows.launches
    imp = tfp.attn_importance_rows(q, k, rows, m, l, kv)
    assert tfp.attn_importance_rows.launches == launches + 1
    imp_p = tfp.attn_importance_rows_plain(q, k, rows, m, l, kv)
    assert (imp - imp_p).abs().max() <= 1e-4 * imp_p.abs().max()
