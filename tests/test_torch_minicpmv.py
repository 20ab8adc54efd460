"""PyTorch port vs the JAX package: the MiniCPM-V 2.6 family (SigLIP's last
hidden state through the perceiver resampler, each frame's block followed
by two separator rows that carry patch ids).

The pieces and the path end to end, on the same weights
(``params_from_numpy``) and inputs (numpy, from seeds):

* the adapter on tests/test_adapters.py's bound tables and on a frame of
  two slices (the window runs to the last bound's end + 2): EQUAL;
  ``sincos_pos_embed_2d``: bit for bit, up to the 70 x 70 grid at width
  3,584;
* ``resample``, ``params_from_remote`` (the fused ``in_proj`` split in
  three) and ``encode_video`` on both attention paths, fp32 both sides:
  ``TOWER_TOL`` of the largest feature;
* ``load_checkpoint`` on the ``MiniCPMV`` hub layout: the LLM, ``vpm.``
  tower and ``resampler.`` EQUAL JAX's loaded params; features within
  ``TOWER_TOL``; a state without its resampler loads the LLM only, in both
  packages;
* ``TextPipeline.ask`` on uint8 frames: embeddings within ``TOWER_TOL``,
  patch types (``patch_num`` = tokens a frame + 2), bounds, prompt ids,
  events, cache lengths and the answer EQUAL JAX's;
* the fused, planned, segmented and dense prefills and ``generate`` on a
  MiniCPM-V prompt that merges (separators with separators) and prunes:
  events, cache lengths and tokens EQUAL JAX's, logits within
  ``LOGIT_TOL`` of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from checkpoint_fixtures import write_fixture
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters import minicpmv as jad
from framefusion_tpu.models.vision import minicpmv_frontend as jmf
from framefusion_tpu.models.vision import siglip as js
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.weights import _load_vision as jax_load_vision
from framefusion_tpu.weights import load_checkpoint as jax_load_checkpoint
from framefusion_tpu.weights import load_state as jax_load_state
from framefusion_tpu_torch.config import FrameFusionConfig, tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import minicpmv as tad
from framefusion_tpu_torch.models.vision import minicpmv_frontend as tmf
from framefusion_tpu_torch.models.vision import siglip as ts
from framefusion_tpu_torch.pipeline import DEFAULT_TEMPLATE, TextPipeline
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.weights import _load_vision, llm_config_from_hf, load_checkpoint, load_state
from test_pipeline import StubTokenizer

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

TOWER_TOL = 1e-5
LOGIT_TOL = 1e-4
FF = dict(cost=0.4, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32)
TPF = 8  # resampled tokens a frame


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def lens(res):
    return [int(c[2]) for c in res.layer_caches]


def same_inputs(got, want):
    np.testing.assert_array_equal(got.patch_type, want.patch_type)
    np.testing.assert_array_equal(np.asarray(got.position_ids), np.asarray(want.position_ids))
    assert (got.patch_num, got.image_token_start, got.image_token_length, got.num_importance_queries) == \
           (want.patch_num, want.image_token_start, want.image_token_length, want.num_importance_queries)
    emb = got.input_embeds.numpy() if isinstance(got.input_embeds, torch.Tensor) else got.input_embeds
    ref = np.asarray(want.input_embeds)
    np.testing.assert_allclose(emb, ref, atol=TOWER_TOL * np.abs(ref).max())


# -- the adapter and the position table ---------------------------------------------------------


@pytest.mark.parametrize("bounds,s,n_frames", [
    ([[4, 14], [16, 26]], 32, 2),  # tests/test_adapters.py: 10 tokens + 2 separators a frame
    ([[3, 7], [8, 12]], 20, 2),  # the span by argmax over the flipped mask
    ([[2, 6], [6, 10], [12, 16], [16, 20]], 26, 2),  # two slices a frame
])
def test_adapter_matches_jax(bounds, s, n_frames):
    """Patch types (the running index modulo the frame distance over
    ``[first start, last end + 2)``: separators carry ids), the span and
    ``patch_num``: EQUAL JAX's, on numpy and on a tensor."""
    emb = np.random.default_rng(6).standard_normal((s, 16)).astype(np.float32)
    want = jad.build_prefill_inputs(emb, np.asarray(bounds), num_frames=n_frames)
    same_inputs(tad.build_prefill_inputs(emb, np.asarray(bounds), num_frames=n_frames), want)
    got = tad.build_prefill_inputs(torch.from_numpy(emb), bounds, num_frames=n_frames)
    same_inputs(got, want)
    assert got.patch_num == bounds[len(bounds) // n_frames][0] - bounds[0][0]
    assert got.image_token_start + got.image_token_length == bounds[-1][1] + 2


@pytest.mark.parametrize("h,w,dim", [(3, 5, 64), (4, 4, 64), (70, 70, 3584)])
def test_sincos_pos_embed_bitwise(h, w, dim):
    got = tmf.sincos_pos_embed_2d(h, w, dim)
    want = jmf.sincos_pos_embed_2d(h, w, dim)
    assert got.dtype == want.dtype == np.float32 and got.shape == (h * w, dim)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of 4"):
        tmf.sincos_pos_embed_2d(h, w, dim + 2)


# -- the resampler ------------------------------------------------------------------------------


def _moved(params, seed):
    """JAX's random params with every LayerNorm and bias moved off 1 / 0."""
    rng = np.random.default_rng(seed)
    return {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k.startswith(("ln", "b_")) else v
            for k, v in jax.device_get(params).items()}


def test_resample_matches_jax():
    """(B 2, a 5 x 3 grid of kv_dim 48) -> (2, 8, 64) within TOWER_TOL, the
    grid's positions included (a permuted patch order changes the output)."""
    cfg_j = jmf.tiny_resampler_config(kv_dim=48)
    params = _moved(jmf.init_params(cfg_j, jax.random.PRNGKey(0)), 1)
    feats = (np.random.default_rng(2).standard_normal((2, 15, 48)) * 0.5).astype(np.float32)
    want = np.asarray(jmf.resample(params, jnp.asarray(feats), 5, 3, cfg_j))
    tparams = tmf.params_from_numpy(params, device="cpu")
    got = tmf.resample(tparams, torch.from_numpy(feats), 5, 3, tmf.tiny_resampler_config(kv_dim=48))
    assert got.shape == want.shape == (2, 8, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max())
    perm = np.random.default_rng(3).permutation(15)
    moved = tmf.resample(tparams, torch.from_numpy(feats[:, perm]), 5, 3, tmf.tiny_resampler_config(kv_dim=48))
    assert not torch.allclose(moved, got, atol=1e-4)


def _remote_state(cfg, seed, prefix="resampler."):
    """A random hub-layout ``Resampler`` state (fused in_proj with biases)."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.1

    sd = {"query": r(cfg.num_queries, d), "kv_proj.weight": r(d, cfg.kv_dim), "attn.in_proj_weight": r(3 * d, d),
          "attn.in_proj_bias": r(3 * d), "attn.out_proj.weight": r(d, d), "attn.out_proj.bias": r(d), "proj": r(d, d)}
    for ln in ("ln_q", "ln_kv", "ln_post"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = 1 + r(d), r(d)
    return {prefix + k: v for k, v in sd.items()}


def test_params_from_remote_matches_jax():
    """The fused ``attn.in_proj_*`` split into q, k, v, ``kv_proj`` with no
    bias, the raw ``proj``: EQUAL JAX's import, key for key; a tensor state
    imports alike; the resampled features within TOWER_TOL."""
    cfg_j, cfg_t = jmf.tiny_resampler_config(), tmf.tiny_resampler_config()
    sd = _remote_state(cfg_t, 4)
    want = jax.device_get(jmf.params_from_remote(sd, cfg_j))
    got = tmf.params_from_remote(sd, cfg_t, device="cpu")
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    d = cfg_t.embed_dim
    np.testing.assert_array_equal(got["w_v"].numpy(), sd["resampler.attn.in_proj_weight"][2 * d:].T)
    from_tensors = tmf.params_from_remote({k: torch.from_numpy(v) for k, v in sd.items()}, cfg_t, device="cpu")
    assert all(torch.equal(from_tensors[k], got[k]) for k in got)
    feats = np.random.default_rng(5).standard_normal((1, 16, cfg_t.kv_dim)).astype(np.float32)
    w = np.asarray(jmf.resample(want, jnp.asarray(feats), 4, 4, cfg_j))
    np.testing.assert_allclose(tmf.resample(got, torch.from_numpy(feats), 4, 4, cfg_t).numpy(), w,
                               atol=TOWER_TOL * np.abs(w).max())


def test_init_params_layout():
    """``init_params`` draws JAX's layout from a torch Generator: the same
    keys, shapes and dtypes; LayerNorms at 1 / 0, biases 0."""
    jp = jmf.init_params(jmf.tiny_resampler_config(), jax.random.PRNGKey(0))
    tp = tmf.init_params(tmf.tiny_resampler_config(), torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    assert all((tp[k] == 1).all() for k in tp if k.startswith("ln") and k.endswith("_w"))
    assert not any(tp[k].any() for k in tp if k.startswith("b_") or (k.startswith("ln") and k.endswith("_b")))


def test_encode_video_matches_jax():
    """SigLIP's last hidden state (post LayerNorm) then the resampler, across
    a frame batch boundary, on each attention path: within TOWER_TOL."""
    vcfg = js.tiny_vit_config()
    rcfg = jmf.tiny_resampler_config(kv_dim=vcfg.hidden_size)
    vit = jax.device_get(js.init_params(vcfg, jax.random.PRNGKey(1)))
    res = _moved(jmf.init_params(rcfg, jax.random.PRNGKey(2)), 3)
    pixels = np.random.default_rng(4).standard_normal((5, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jmf.encode_video(vit, vcfg, res, rcfg, jnp.asarray(pixels), frame_batch=3))
    tvit, tres = ts.params_from_numpy(vit, device="cpu"), tmf.params_from_numpy(res, device="cpu")
    for impl in ("flash", "einsum"):
        got = tmf.encode_video(tvit, ts.tiny_vit_config(), tres, tmf.tiny_resampler_config(kv_dim=vcfg.hidden_size),
                               pixels, frame_batch=3, attn_impl=impl)
        assert got.shape == want.shape == (5, rcfg.num_queries, rcfg.embed_dim)
        np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max(), err_msg=impl)


# -- checkpoints -------------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if k == "cfg":
            continue
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_load_checkpoint_matches_jax(tmp_path):
    """``MiniCPMV``: the LLM (``llm.model.``), the SigLIP tower (``vpm.``, at
    the config's image size) and the resampler (``resampler.``: 8 queries,
    the LLM width, hidden // 128 heads) EQUAL JAX's loaded params (fp32
    both sides); the loaded frontend's features within TOWER_TOL of JAX's;
    without its resampler the state loads the LLM only, in both packages."""
    path = write_fixture(tmp_path, "minicpmv")
    ref = jax_load_checkpoint(path, dtype=jnp.float32)
    got = load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert got.family == ref.family == "minicpmv" and got.vision["kind"] == ref.vision["kind"] == "minicpmv"
    for attr in ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers", "num_heads"):
        assert getattr(got.vision["cfg"], attr) == getattr(ref.vision["cfg"], attr), attr
    rc, jrc = got.vision["projector"]["cfg"], ref.vision["projector"]["cfg"]
    assert (rc.num_queries, rc.embed_dim, rc.num_heads, rc.kv_dim) == \
           (jrc.num_queries, jrc.embed_dim, jrc.num_heads, jrc.kv_dim) == (8, 64, 1, 64)
    for part, t_tree, j_tree in (("llm.", got.params, ref.params), ("tower.", got.vision["params"],
                                                                     ref.vision["params"]),
                                 ("resampler.", got.vision["projector"], ref.vision["projector"])):
        flat_t, flat_j = _flat(t_tree), _flat(jax.device_get(j_tree))
        assert flat_t.keys() == flat_j.keys(), part
        for name, t in flat_t.items():
            assert t.dtype == torch.float32, part + name
            np.testing.assert_array_equal(t.numpy(), np.asarray(flat_j[name], np.float32), err_msg=part + name)
    pixels = np.random.default_rng(1).standard_normal((3, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jmf.encode_video(ref.vision["params"], ref.vision["cfg"], ref.vision["projector"]["params"],
                                       jrc, jnp.asarray(pixels)))
    feats = tmf.encode_video(got.vision["params"], got.vision["cfg"], got.vision["projector"]["params"], rc, pixels)
    np.testing.assert_allclose(feats.numpy(), want, atol=TOWER_TOL * np.abs(want).max())

    import json

    with open(f"{path}/config.json") as f:
        cfg_dict = json.load(f)
    family, llm_cfg = llm_config_from_hf(cfg_dict)
    partial = {k: v for k, v in load_state(path).items() if not k.startswith("resampler.attn.")}
    assert family == "minicpmv" and _load_vision(family, partial, cfg_dict, llm_cfg, "cpu") is None
    j_partial = {k: v for k, v in jax_load_state(path).items() if not k.startswith("resampler.attn.")}
    assert jax_load_vision(family, j_partial, cfg_dict, ref.cfg) is None
    bf16 = load_checkpoint(path, device="cpu")  # the default dtype: the tower bf16, the resampler fp32
    assert bf16.vision["params"]["pos_embed"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in bf16.vision["projector"]["params"].values())


# -- the pipeline ------------------------------------------------------------------------------


def uint8_frames(seed, n=6, h=45, w=61):
    """Camera-sized frames of one scene drifting slowly (adjacent frames alike)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    frames = [base + rng.normal(0, 2 + 12 * (i % 3), base.shape) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, the port's plain-path pipeline, the port's "flash"
    pipeline) over one tiny LLM, SigLIP tower and resampler."""
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(7))
    vcfg = js.tiny_vit_config()
    vit = js.init_params(vcfg, jax.random.PRNGKey(8))
    rcfg = jmf.tiny_resampler_config(embed_dim=jcfg.hidden_size, kv_dim=vcfg.hidden_size)
    res = jmf.init_params(rcfg, jax.random.PRNGKey(9))
    knobs = (0.5, 0.97, 0.05)
    jm = jax_apply(JaxModel(family="minicpmv", cfg=jcfg, params=jp, attn_impl="einsum"), *knobs)
    jm.ff = jm.ff.replace(schedule_num_layers=4)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg,
                        projector={"params": res, "cfg": rcfg})
    tcfg = tiny_llm_config(num_layers=4)
    tp, tvit, tres = (tq.params_from_numpy(jax.device_get(t), device="cpu") for t in (jp, vit, res))
    tproj = {"params": tres, "cfg": tmf.tiny_resampler_config(embed_dim=tcfg.hidden_size, kv_dim=vcfg.hidden_size)}
    out = [jpipe]
    for impl in ("einsum", "flash"):
        tm = apply_framefusion(FrameFusionModel(family="minicpmv", cfg=tcfg, params=tp, attn_impl=impl), *knobs)
        tm.ff = tm.ff.replace(schedule_num_layers=4)
        out.append(TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=tvit, vit_cfg=ts.tiny_vit_config(),
                                projector=tproj))
    return out


def test_ask_on_uint8_frames_matches_jax(pipes):
    """Pixels to answer: SigLIP at 28 px, the resampler's 8 tokens a frame,
    each block followed by the two separator rows (``patch_num`` 10, the
    separators' ids 8 and 9): inputs, prompt ids, events, cache lengths and
    the answer EQUAL JAX's; the "flash" pipeline makes the same decisions;
    precomputed features give the same answer."""
    jpipe, tpipe, fpipe = pipes
    frames = uint8_frames(0)
    inp_j, inp_t = jpipe.build_inputs("Q?", frames=frames), tpipe.build_inputs("Q?", frames=frames)
    same_inputs(inp_t, inp_j)
    assert inp_t.patch_num == 10 and (inp_t.patch_type >= 0).sum() == 6 * 10
    span = inp_t.patch_type[inp_t.image_token_start:inp_t.image_token_start + inp_t.image_token_length]
    np.testing.assert_array_equal(span, np.tile(np.arange(10), 6))
    before, _, after = DEFAULT_TEMPLATE.format(question="Q?").partition("<image>")
    enc = StubTokenizer().encode
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids == enc(before) + enc(after) + enc(")\n")[:2]
    answer = tpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert answer == jpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    res_t, res_j = tpipe.last_result, jpipe.last_result
    assert events(res_t) == events(res_j) and any(e[1] == "merge" and e[2] for e in events(res_t))
    assert lens(res_t) == lens(res_j)
    fpipe.ask("What happens?", frames=frames, max_new_tokens=6)
    assert events(fpipe.last_result) == events(res_j) and lens(fpipe.last_result) == lens(res_t)
    feats = tmf.encode_video(tpipe.vit_params, tpipe.vit_cfg, tpipe.projector["params"], tpipe.projector["cfg"],
                             tpipe._prepare_frames(frames), attn_impl="einsum")
    assert tpipe.ask("What happens?", video_features=feats, max_new_tokens=6) == answer
    with pytest.raises(ValueError, match="n_frames, tokens_per_frame"):
        tpipe.ask("Q?", video_features=feats.reshape(-1, feats.shape[-1]))
    with pytest.raises(ValueError, match="resampler"):
        TextPipeline(model=tpipe.model, tokenizer=StubTokenizer(), vit_params=tpipe.vit_params,
                     vit_cfg=tpipe.vit_cfg).ask("Q?", frames=frames)


# -- the engine -------------------------------------------------------------------------------------


def minicpmv_prompt(seed, hidden, n_frames=6, tpf=TPF, n_pre=5, n_post=7, coherent=0.5):
    """(embeds (S, hidden), bounds) of a MiniCPM-V prompt at embedding scale
    0.05: per frame ``tpf`` resampled rows, a ``coherent`` share of them like
    the previous frame's (scales that spread the similarities), then the same
    two separator rows every frame (so the separators merge with their
    predecessors')."""
    rng = np.random.default_rng(seed)
    sep = rng.standard_normal((2, hidden))
    chunks, bounds, cursor, prev = [rng.standard_normal((n_pre, hidden))], [], n_pre, None
    for _ in range(n_frames):
        frame = rng.standard_normal((tpf, hidden))
        if prev is not None:
            scale = rng.uniform(0.05, 0.5, size=(tpf, 1))
            frame = np.where((rng.random(tpf) < coherent)[:, None], prev + scale * frame, frame)
        prev = frame
        chunks += [frame, sep]
        bounds.append([cursor, cursor + tpf])
        cursor += tpf + 2
    chunks.append(rng.standard_normal((n_post, hidden)))
    return (np.concatenate(chunks) * 0.05).astype(np.float32), np.asarray(bounds)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(14))
    return jcfg, tiny_llm_config(num_layers=4), jp, tq.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("mode", ["fused", "planned", "segmented", "dense"])
def test_prefill_and_generate_match_jax(stacks, mode):
    """Each executor on a MiniCPM-V prompt whose separators carry patch ids:
    events (a merge that takes the separators, then the prune), cache
    lengths and the live rows' layer-0 keys EQUAL JAX's / to tolerance,
    logits to tolerance, then 6 greedy tokens EQUAL JAX's; the "flash"
    engine (the kernels' plain versions) makes the same decisions."""
    jcfg, tcfg, jp, tp = stacks
    embeds, bounds = minicpmv_prompt(1, tcfg.hidden_size)
    inp_j = jad.build_prefill_inputs(embeds, bounds, num_frames=6)
    inp_t = tad.build_prefill_inputs(embeds, bounds, num_frames=6)
    assert inp_t.patch_num == TPF + 2
    args = [(i.input_embeds, i.patch_type, i.position_ids, i.patch_num, i.image_token_start, i.image_token_length)
            for i in (inp_j, inp_t)]
    eng_j = JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum")
    res_j = eng_j.prefill(*args[0], mode=mode)
    eng_t = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum")
    res_t = eng_t.prefill(*args[1], mode=mode)
    assert res_t.mode == res_j.mode and res_t.valid_len == res_j.valid_len and lens(res_t) == lens(res_j)
    if mode != "dense":
        assert events(res_t) == events(res_j)
        ev = events(res_t)
        assert ev[0][1] == "merge" and ev[0][2] >= 2 * 5 and any(e[1] == "prune" for e in ev)
    n0 = lens(res_t)[0]
    k_j = np.asarray(res_j.layer_caches[0][0])[:n0]
    np.testing.assert_allclose(res_t.layer_caches[0][0][:n0].numpy(), k_j, atol=LOGIT_TOL * np.abs(k_j).max())
    want = np.asarray(res_j.logits)
    np.testing.assert_allclose(res_t.logits.numpy(), want, atol=LOGIT_TOL * np.abs(want).max())
    assert eng_t.generate(res_t, 6) == eng_j.generate_greedy(res_j, 6)
    res_f = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF)).prefill(*args[1], mode=mode)
    assert lens(res_f) == lens(res_t) and (mode == "dense" or events(res_f) == events(res_t))
