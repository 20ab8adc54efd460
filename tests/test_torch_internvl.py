"""PyTorch port vs the JAX package: the InternVL family (InternViT, the
InternLM2 backbone, the interleaved ``FrameN: <image>`` prompt).

The pieces of the family and its path end to end, on the same weights
(``params_from_numpy``) and inputs (numpy, from seeds):

* ``internlm2_8b_config`` and the family's ``FamilySpec``: EQUAL JAX's;
* ``params_from_state_dict_internlm2`` on a fused ``wqkv`` with g = Hq / Hk
  = 4 and Hk = 2 (a g of 1 or a single KV head cannot tell a wrong
  un-interleave from a right one): EQUAL JAX's params and the per-head
  weights the state was fused from, float and int8;
* the adapter (patch types, the span that takes the text between frames,
  positions): EQUAL; ``pixel_shuffle``: bit for bit;
* InternViT's ``encode`` and ``extract_features`` with and without qkv bias
  and qk norm, on both attention paths: ``TOWER_TOL`` of the largest
  feature (fp32 both sides, sums in other orders);
* the engine's fused, planned, segmented and dense prefills and
  ``generate`` on a no-bias Hq 8 / Hk 2 stack and an interleaved prompt,
  FastV through ``replace_forward`` and ``generate_batch`` on two prompts
  of different lengths: events, cache lengths and tokens EQUAL; last-token
  logits within ``LOGIT_TOL`` of the largest (fp32 both sides, JAX's
  ``attn_impl="einsum"`` against the port's plain path).

Cases that need the card (``gpu``): kernel E at InternViT-300M's (B, 1025,
16, 64) and kernels A + B at InternLM2's groups of 4 (Hq 32 / Hk 8) against
their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines import replace_forward as jax_replace_forward
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import internlm2_8b_config as jax_internlm2
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FAMILIES as JAX_FAMILIES
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters import internvl as jad
from framefusion_tpu.models.adapters.common import PrefillInputs as JaxInputs
from framefusion_tpu.models.vision import internvl_vit as jvit
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.weights import params_from_state_dict_internlm2 as jax_import
from framefusion_tpu_torch.baselines import replace_forward
from framefusion_tpu_torch.config import FrameFusionConfig, internlm2_8b_config, tiny_llm_config
from framefusion_tpu_torch.interface import FAMILIES, FrameFusionModel, apply_framefusion, get_token_type
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import internvl as tad
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.models.vision import internvl_vit as tvit
from framefusion_tpu_torch.ops.attention import capture_rows
from framefusion_tpu_torch.ops.kernels import bidir_attention as tba
from framefusion_tpu_torch.ops.kernels import flash_prefill as tfp
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.weights import params_from_state_dict_internlm2
from test_weights import make_internlm2_state_dict

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOWER_TOL = 1e-5
LOGIT_TOL = 1e-4
GQA = dict(num_layers=4, num_heads=8, num_kv_heads=2, qkv_bias=False)  # g = 4, as InternLM2.5-7B's
FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)
TPF = 8  # tokens a frame


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def lens(res):
    return [int(c[2]) for c in res.layer_caches]


def assert_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=LOGIT_TOL * np.abs(want).max())


def interleaved_prompt(seed, hidden, n_frames=6, tpf=TPF, n_pre=5, gap=3, n_post=7, coherent=0.5):
    """(embeds (S, hidden), image mask (S,)) of an InternVL-style prompt at
    embedding scale 0.05: ``n_pre`` text rows, then per frame ``tpf`` image
    rows followed by ``gap`` text rows (the next ``FrameN:`` label), then
    ``n_post`` text rows. A ``coherent`` share of each frame's rows resemble
    the previous frame's (scales that spread the similarities, as
    ``build_video_prompt``), the rest are new."""
    rng = np.random.default_rng(seed)
    rows, mask, prev = [rng.standard_normal((n_pre, hidden))], [np.zeros(n_pre, bool)], None
    for f in range(n_frames):
        frame = rng.standard_normal((tpf, hidden))
        if prev is not None:
            scale = rng.uniform(0.05, 0.5, size=(tpf, 1))
            frame = np.where((rng.random(tpf) < coherent)[:, None], prev + scale * frame, frame)
        prev = frame
        tail = gap if f < n_frames - 1 else n_post
        rows += [frame, rng.standard_normal((tail, hidden))]
        mask += [np.ones(tpf, bool), np.zeros(tail, bool)]
    return (np.concatenate(rows) * 0.05).astype(np.float32), np.concatenate(mask)


def prompt_inputs(seed, hidden, **kw):
    """(JAX PrefillInputs, the port's) of one interleaved prompt, from each
    package's adapter."""
    embeds, mask = interleaved_prompt(seed, hidden, **kw)
    tpf = kw.get("tpf", TPF)
    return jad.build_prefill_inputs(embeds, mask, tpf), tad.build_prefill_inputs(embeds, mask, tpf)


def prefill_args(inp):
    return (inp.input_embeds, inp.patch_type, inp.position_ids, inp.patch_num, inp.image_token_start,
            inp.image_token_length)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(**GQA)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(12))
    return jcfg, tiny_llm_config(**GQA), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


# -- config, weights, adapter -------------------------------------------------------------


def test_internlm2_config_and_family_match_jax():
    jcfg, tcfg = jax_internlm2(), internlm2_8b_config()
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
              "head_dim_", "rms_norm_eps", "rope_theta", "tie_word_embeddings", "qkv_bias", "mrope_section"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.head_dim_, tcfg.qkv_bias) == (4, 128, False)
    assert tcfg.dtype == torch.bfloat16
    spec, jspec = FAMILIES["internvl"], JAX_FAMILIES["internvl"]
    for f in ("adapter_module", "llm_prefix", "num_importance_queries", "default_similarity_lower_bound",
              "qkv_bias", "mrope"):
        assert getattr(spec, f) == getattr(jspec, f), f
    assert (spec.num_importance_queries, spec.default_similarity_lower_bound, spec.qkv_bias,
            spec.llm_prefix) == (1, 0.5, False, "language_model.model.")
    assert get_token_type("internvl") is tad


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_internlm2_import_matches_jax(quantize):
    """The fused wqkv at g = 4, Hk = 2 (rows grouped [4 q, 1 k, 1 v] per KV
    head) unpacks to the per-head weights it was fused from and to JAX's
    params; the other names map as JAX maps them; int8 EQUAL JAX's pairs."""
    cfg_j, cfg_t = jax_tiny(**GQA).replace(num_layers=2), tiny_llm_config(**GQA).replace(num_layers=2)
    sd, expect = make_internlm2_state_dict(cfg_j, seed=3)
    jp = jax.device_get(jax_import(sd, cfg_j, quantize=quantize))
    tp = params_from_state_dict_internlm2(sd, cfg_t, quantize=quantize, device="cpu")
    assert set(tp) == set(jp) == {"embed", "layers", "final_norm", "lm_head"}
    assert set(tp["layers"]) == set(jp["layers"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                      "w_down"}
    for name, t in tp["layers"].items():
        j = jp["layers"][name]
        if isinstance(t, dict):
            np.testing.assert_array_equal(t["q8"].numpy(), np.asarray(j["q8"]), err_msg=name)
            np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
            if name in expect:
                np.testing.assert_array_equal(t.numpy(), np.stack(expect[name]), err_msg=name)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]), err_msg=name)
    with pytest.raises(ValueError, match="no qkv bias"):
        params_from_state_dict_internlm2(sd, cfg_t.replace(qkv_bias=True), device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(n_frames=3, tpf=5, gap=1, n_pre=2, n_post=1), dict(gap=0)])
def test_adapter_matches_jax(kw):
    """Patch types, the span (text between frames inside it: the reference's
    quirk), positions and the metadata EQUAL JAX's."""
    inp_j, inp_t = prompt_inputs(0, 16, **kw)
    np.testing.assert_array_equal(inp_t.patch_type, inp_j.patch_type)
    np.testing.assert_array_equal(inp_t.position_ids, np.asarray(inp_j.position_ids))
    assert (inp_t.patch_num, inp_t.image_token_start, inp_t.image_token_length, inp_t.num_importance_queries) == \
           (inp_j.patch_num, inp_j.image_token_start, inp_j.image_token_length, inp_j.num_importance_queries)
    span = inp_t.patch_type[inp_t.image_token_start:inp_t.image_token_start + inp_t.image_token_length]
    assert ((span < 0).sum() > 0) == (kw.get("gap", 3) > 0)
    with pytest.raises(ValueError, match="multiple of the frame size"):
        tad.build_prefill_inputs(inp_t.input_embeds, inp_t.patch_type >= 0, inp_t.patch_num + 1)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 32, 32, 1024), (3, 6, 6, 12)])
def test_pixel_shuffle_bitwise(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tvit.pixel_shuffle(torch.from_numpy(x), 0.5)
    want = np.asarray(jvit.pixel_shuffle(jnp.asarray(x), 0.5))
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3] * 4)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the tower ----------------------------------------------------------------------------


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (True, True)])
def test_encode_and_extract_features_match_jax(bias, qk_norm):
    """JAX's random tower (with random norms, biases and layer scales)
    through both packages: ``encode`` on each attention path and
    ``extract_features`` within TOWER_TOL of the largest value."""
    cfg_j = jvit.tiny_internvit_config(attention_bias=bias, use_qk_norm=qk_norm)
    cfg_t = tvit.tiny_internvit_config(attention_bias=bias, use_qk_norm=qk_norm)
    vit_j = jax.device_get(jvit.init_params(cfg_j, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    for name, arr in vit_j["layers"].items():  # move the norms, biases and scales off their constants
        vit_j["layers"][name] = arr + rng.standard_normal(arr.shape).astype(np.float32) * 0.1
    proj_j = jax.device_get(jvit.init_projector(cfg_j, jax.random.PRNGKey(3)))
    vit_t, proj_t = (tq.params_from_numpy(t, device="cpu") for t in (vit_j, proj_j))
    pixels = rng.standard_normal((3, 30, 29, 3)).astype(np.float32)  # cropped to 28 x 28, as the conv does
    want = np.asarray(jvit.encode(vit_j, jnp.asarray(pixels), cfg_j, attn_impl="einsum"))
    for impl in ("flash", "einsum"):
        got = tvit.encode(vit_t, pixels, cfg_t, attn_impl=impl)
        assert got.shape == (3, cfg_t.num_patches + 1, cfg_t.hidden_size)
        np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max(), err_msg=impl)
    want = np.asarray(jvit.extract_features(vit_j, proj_j, jnp.asarray(pixels), cfg_j))
    got = tvit.extract_features(vit_t, proj_t, pixels, cfg_t)
    assert got.shape == (3, cfg_t.tokens_per_image, cfg_t.text_hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown attention impl"):
        tvit.encode(vit_t, pixels, cfg_t, attn_impl="pallas")


# -- the engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "planned", "segmented", "dense"])
def test_prefill_and_generate_match_jax(stacks, mode):
    """Each executor on a no-bias Hq 8 / Hk 2 stack and an interleaved
    prompt whose prune window holds the text between frames: events, cache
    lengths and the live rows' layer-0 keys EQUAL JAX's / to tolerance,
    logits to tolerance, then 6 greedy tokens EQUAL JAX's; the "flash"
    engine (the kernels' plain versions) makes the same decisions."""
    jcfg, tcfg, jp, tp = stacks
    eng_j = JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum")
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum")
    inp_j, inp_t = prompt_inputs(1, tcfg.hidden_size)
    res_j = eng_j.prefill(*prefill_args(inp_j), mode=mode)
    res_t = eng_t.prefill(*prefill_args(inp_t), mode=mode)
    assert res_t.mode == res_j.mode and res_t.valid_len == res_j.valid_len
    if mode != "dense":
        assert events(res_t) == events(res_j)
        assert any(e[1] == "prune" for e in events(res_t)) and any(e[1] == "merge" and e[2] for e in events(res_t))
    assert lens(res_t) == lens(res_j)
    n0 = lens(res_t)[0]
    k_j = np.asarray(res_j.layer_caches[0][0])[:n0]
    np.testing.assert_allclose(res_t.layer_caches[0][0][:n0].numpy(), k_j, atol=LOGIT_TOL * np.abs(k_j).max())
    assert_logits(res_t.logits, res_j.logits)
    assert eng_t.generate(res_t, 6) == eng_j.generate_greedy(res_j, 6)
    res_f = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF)).prefill(*prefill_args(inp_t), mode=mode)
    assert lens(res_f) == lens(res_t) and (mode == "dense" or events(res_f) == events(res_t))


def test_fastv_and_generate_batch_match_jax(stacks):
    """The model's entry points on the family: FastV through
    ``replace_forward`` then ``generate``, and FrameFusion's
    ``generate_batch`` on two interleaved prompts of different lengths
    (fused and the lockstep batch): tokens, events and cache lengths EQUAL
    JAX's."""
    jcfg, tcfg, jp, tp = stacks
    jm = JaxModel(family="internvl", cfg=jcfg, params=jp, attn_impl="einsum")
    tm = FrameFusionModel(family="internvl", cfg=tcfg, params=tp, attn_impl="einsum")
    pairs = [prompt_inputs(2, tcfg.hidden_size), prompt_inputs(3, tcfg.hidden_size, n_frames=5, gap=2, n_post=4)]
    ins_j = [JaxInputs(**vars(p[0])) for p in pairs]
    ins_t = [p[1] for p in pairs]
    assert len(ins_t[0].patch_type) != len(ins_t[1].patch_type)

    fastv = dict(fastv_k=2, fastv_r=0.5)
    toks_j, res_j = jax_replace_forward(jm, "fastv", **fastv).generate(ins_j[0], max_new_tokens=5)
    toks_t, res_t = replace_forward(tm, "fastv", **fastv).generate(ins_t[0], max_new_tokens=5)
    assert toks_t == toks_j and events(res_t) == events(res_j) and lens(res_t) == lens(res_j)
    assert any(e[2] for e in events(res_t))
    assert_logits(res_t.logits, res_j.logits)

    jm, tm = jax_apply(jm, 0.4, 0.75, 0.05), apply_framefusion(tm, 0.4, 0.75, 0.05)
    for m in (jm, tm):
        m.ff = m.ff.replace(schedule_num_layers=4, bucket=32)
    for mode in ("fused", "planned_batch"):
        toks_j, res_j = jm.generate_batch(ins_j, max_new_tokens=4, mode=mode)
        toks_t, res_t = tm.generate_batch(ins_t, max_new_tokens=4, mode=mode)
        assert toks_t == toks_j, mode
        for a, b in zip(res_j, res_t):
            assert (b.mode, events(b), lens(b)) == (a.mode, events(a), lens(a)), mode
    assert tm.generate_batch(ins_t, max_new_tokens=4)[0] == [tm.generate(i, max_new_tokens=4)[0] for i in ins_t]


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_bidir_kernel_at_internvit_shape(cuda):
    """Kernel E at (B 8, N 1025, H 16, hd 64): InternViT-300M's 1,024
    patches + CLS, one key past a 64-key tile; every (row, head) within 2e-2
    of its largest output (tests/test_torch_vision.py's bound), the last
    query row and the last key's column held on their own."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    q, k, v = (torch.randn((8, 1025, 16, 64), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    k[:, -1] *= 4  # the last key draws a large share of every row's mass
    launches = tba.bidir_attn_fwd.launches
    out = tba.flash_bidir_attention(q, k, v)
    assert tba.bidir_attn_fwd.launches == launches + 1
    ref = tba.bidir_attn_fwd_plain(q, k, v, 64 ** -0.5)
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 2e-2 * ref.float().abs().amax(-1)).all()
    assert (err[:, -1] <= 2e-2 * ref[:, -1].float().abs().amax(-1)).all()
    v_last = torch.zeros_like(v)
    v_last[:, -1] = 1  # the output is then the last key's probability
    p_last = tba.flash_bidir_attention(q, k, v_last)[..., 0].float()
    p_ref = tba.bidir_attn_fwd_plain(q, k, v_last, 64 ** -0.5)[..., 0].float()
    assert (p_last - p_ref).abs().max() <= 2e-2 * p_ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_attention_and_importance_at_groups_of_four(cuda, masked):
    """Kernel A at Hq 32 / Hk 8 (InternLM2.5-7B), S 2,304, with and without
    dead keys: per (row, head) within 2e-2 of its largest output; then
    kernel B from A's statistics at one capture row: 1e-4 of the largest
    importance (tests/test_torch_kernels.py's bounds)."""
    s = 2304
    gen = torch.Generator(device=cuda).manual_seed(32)
    q = torch.randn((s, 32, 128), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((s, 8, 128), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(2))
    kv = None
    if masked:
        kv = torch.rand((s,), generator=gen, device=cuda) > 0.4
        kv[-32:] = True  # the trailing text stays live
    out, m, l = tfp.flash_attn_fwd(q, k, v, kv)
    out_p, _, _ = tfp.flash_attn_fwd_plain(q, k, v, kv)
    err = (out.float() - out_p.float()).abs().amax(-1)
    assert (err <= 2e-2 * out_p.float().abs().amax(-1).clamp(min=1e-30)).all()
    rows = capture_rows(s, 1, s, kv, device=cuda)
    launches = tfp.attn_importance_rows.launches
    imp = tfp.attn_importance_rows(q, k, rows, m, l, kv)
    assert tfp.attn_importance_rows.launches == launches + 1
    imp_p = tfp.attn_importance_rows_plain(q, k, rows, m, l, kv)
    assert (imp - imp_p).abs().max() <= 1e-4 * imp_p.abs().max()
