"""PyTorch port vs the JAX package: the Qwen2-VL family (mRoPE).

The pieces of the family and its path end to end, on the same weights
(``params_from_numpy``) and inputs (numpy, from seeds):

* ``mrope_cos_sin``: each frequency slot takes its angle from the stream
  JAX's section rule picks, bit for bit the port's own 1D table of that
  stream; values within the 1D table's bound against JAX (``VAL_TOL``: XLA's
  and torch's cos/sin differ in the last ulp). Three equal streams are the 1D
  tables bit for bit, which is why decode, verify and serving keep 1D rotary
  at ``decode_pos_base`` (a test pins the whole prefill and decode);
* the adapter (``mrope_position_ids``, ``build_prefill_inputs``, the
  Qwen2.5-VL ``second_per_grid_ts`` rule included), ``pixels_to_patches``
  and the vision rotary: EQUAL;
* the tower (``encode_video``) at a tiny config and a tiny head-dim-80 one:
  ``TOWER_TOL`` of the largest feature (fp32 both sides, sums in other
  orders);
* the engine's fused, planned, segmented and dense prefills, the lockstep
  batch, ``generate``, ``generate_batch``, ``generate_spec`` and the
  serving loop on mRoPE positions, FastV and StreamingLLM: events, cache
  lengths, ``decode_pos_base`` and tokens EQUAL; last-token logits within
  ``LOGIT_TOL`` of the largest (fp32 both sides, JAX's ``attn_impl="einsum"``
  against the port's plain path).

Cases that need the card (``gpu``): kernel E at the Qwen2-VL tower's head
dim 80 and kernel B at 4 capture rows against their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from framefusion_tpu.baselines.qwen2_baselines import BaselineEngine as JaxBaselineEngine
from framefusion_tpu.config import FrameFusionConfig as JaxFF
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.adapters import qwen2_vl as jad
from framefusion_tpu.models.vision import qwen2_vl_vit as jvit
from framefusion_tpu.ops import rope as jrope
from framefusion_tpu.runtime.engine import CompressionEngine as JaxEngine
from framefusion_tpu.runtime.serving import ServeRequest as JaxRequest
from framefusion_tpu.runtime.serving import ServingLoop as JaxLoop
from framefusion_tpu_torch.baselines import BaselineEngine
from framefusion_tpu_torch.config import FrameFusionConfig, qwen2_vl_7b_config, tiny_llm_config
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.adapters import qwen2_vl as tad
from framefusion_tpu_torch.models.adapters.common import PrefillInputs
from framefusion_tpu_torch.models.vision import qwen2_vl_vit as tvit
from framefusion_tpu_torch.ops import rope as trope
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.runtime.serving import ServeRequest, ServingLoop

# Tiny shapes: one intra-op thread each. pytest-xdist workers share the cores, and
# torch's default of a thread per core makes them spin against each other.
torch.set_num_threads(1)

VAL_TOL = 1e-5  # the 1D rope tables' bound (tests/test_torch_core.py)
TOWER_TOL = 1e-5
LOGIT_TOL = 1e-4
SECTION = (4, 6, 6)  # head_dim 32 -> 16 frequency slots
FF = dict(cost=0.5, similarity_lower_bound=0.75, ratio_lower_bound=0.05, schedule_num_layers=4, bucket=32,
          num_importance_queries=4)
GRID = (6, 4, 6)  # grid_t, grid_h, grid_w: 6 merged patches a frame


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


def lens(res):
    return [int(c[2]) for c in res.layer_caches]


def assert_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=LOGIT_TOL * np.abs(want).max())


def qwen_prompt(seed, hidden, grid=GRID, n_pre=5, n_post=6, coherent=0.45):
    """(text rows with one placeholder, video rows, placeholder row) of a
    Qwen2-VL prompt at embedding scale 0.05: a ``coherent`` share of each
    frame's patches resemble the previous frame's (perturbation scales that
    spread the similarities, as ``build_video_prompt``), the rest are new."""
    grid_t, grid_h, grid_w = grid
    patch_num = grid_h * grid_w // 4
    rng = np.random.default_rng(seed)
    text = (rng.standard_normal((n_pre + 1 + n_post, hidden)) * 0.05).astype(np.float32)
    video = (rng.standard_normal((grid_t * patch_num, hidden)) * 0.05).astype(np.float32)
    for f in range(1, grid_t):
        cur, prev = slice(f * patch_num, (f + 1) * patch_num), slice((f - 1) * patch_num, f * patch_num)
        scale = rng.uniform(0.05, 0.5, size=(patch_num, 1)).astype(np.float32)
        blended = video[prev] + scale * rng.standard_normal((patch_num, hidden)).astype(np.float32) * 0.05
        video[cur] = np.where((rng.random(patch_num) < coherent)[:, None], blended, video[cur])
    return text, video, n_pre


def prompt_inputs(seed, hidden, **kw):
    """(JAX PrefillInputs, the port's) of one prompt, from each package's adapter."""
    text, video, at = qwen_prompt(seed, hidden, **kw)
    return (jad.build_prefill_inputs(text, video, at, *kw.get("grid", GRID)),
            tad.build_prefill_inputs(text, video, at, *kw.get("grid", GRID)))


def prefill_args(inp):
    return (inp.input_embeds, inp.patch_type, inp.position_ids, inp.patch_num, inp.image_token_start,
            inp.image_token_length)


@pytest.fixture(scope="module")
def stacks():
    jcfg = jax_tiny(num_layers=4).replace(mrope_section=SECTION)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tiny_llm_config(num_layers=4, mrope_section=SECTION), jp, tq.params_from_numpy(
        jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def engines(stacks):
    """JAX's engine and the port's plain path ("einsum": fp32, as JAX's);
    the port's "flash" engine (the kernels' plain versions: C, D and G round
    to bf16, so a near-tie of this random model may break otherwise than
    fp32) is held to its own plain decodes."""
    jcfg, tcfg, jp, tp = stacks
    return (JaxEngine(jp, jcfg, JaxFF(**FF), attn_impl="einsum"),
            CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum"),
            CompressionEngine(tp, tcfg, FrameFusionConfig(**FF)))


# -- rotary -----------------------------------------------------------------------------


def test_mrope_cos_sin_matches_jax():
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 5000, (3, 40)).astype(np.int32)
    for hd, theta, section in ((32, 1e4, SECTION), (128, 1e6, (16, 24, 24))):
        cos_j, sin_j = jrope.mrope_cos_sin(jnp.asarray(pos3), hd, theta, section)
        cos_t, sin_t = trope.mrope_cos_sin(torch.from_numpy(pos3.astype(np.int64)), hd, theta, section)
        np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=VAL_TOL)
        np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=VAL_TOL)
        # The slot -> stream rule (section i takes stream i % 3, both halves):
        # JAX's table is its own 1D table of that stream slot by slot, and the
        # port's its own, bit for bit.
        sel = np.concatenate([np.repeat(np.arange(3), section)] * 2)[None, None]  # (1, 1, hd)
        for mr_j, mr_t, k in ((cos_j, cos_t, 0), (sin_j, sin_t, 1)):
            per_j = np.stack([np.asarray(jrope.rope_cos_sin(jnp.asarray(p), hd, theta)[k]) for p in pos3])
            per_t = torch.stack([trope.rope_cos_sin(torch.from_numpy(p.astype(np.int64)), hd, theta)[k]
                                 for p in pos3]).numpy()
            np.testing.assert_array_equal(np.asarray(mr_j), np.take_along_axis(per_j, sel, 0)[0])
            np.testing.assert_array_equal(mr_t.numpy(), np.take_along_axis(per_t, sel, 0)[0])
        # Three equal streams: the 1D tables bit for bit.
        tiled = torch.from_numpy(np.tile(pos3[:1], (3, 1)).astype(np.int64))
        for got, want in zip(trope.mrope_cos_sin(tiled, hd, theta, section), trope.rope_cos_sin(tiled[0], hd, theta)):
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        trope.mrope_cos_sin(torch.zeros((3, 4), dtype=torch.int64), 32, 1e4, (4, 4, 4))


def test_positions_dispatch_like_jax(stacks):
    """``token_cos_sin`` on the executors' token-major (..., S, P) equals
    JAX's ``positions_cos_sin`` dispatch, (S,) -> RoPE and (3, S) -> mRoPE,
    within VAL_TOL; ``pos_tokens`` makes that layout from either form."""
    jcfg, tcfg, _, _ = stacks
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 300, 20).astype(np.int64)
    p3 = rng.integers(0, 300, (3, 20)).astype(np.int64)
    for pos in (p1, p3):
        tok = tq.pos_tokens(pos, "cpu")
        assert tok.shape == (20, 1 if pos.ndim == 1 else 3)
        got = tq.token_cos_sin(tok, tcfg)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(jq.positions_cos_sin(jnp.asarray(pos), jcfg)[0]),
                                   atol=VAL_TOL)
        assert torch.equal(tq.token_cos_sin(tok[None].expand(2, -1, -1), tcfg)[0][1], got)
    one_d = tq.token_cos_sin(tq.pos_tokens(p1, "cpu"), tcfg)[0]
    assert torch.equal(tq.positions_cos_sin(torch.from_numpy(p1), tcfg)[0], one_d)
    with pytest.raises(ValueError, match="mrope_section"):
        tq.token_cos_sin(tq.pos_tokens(p3, "cpu"), tiny_llm_config())
    assert qwen2_vl_7b_config().mrope_section == (16, 24, 24)


def test_tiled_stream_mrope_equals_1d_rope(stacks):
    """Three equal position streams through an mRoPE engine are 1D RoPE bit
    for bit: the same events and logits as the 1D engine, and with the same
    decode base the same tokens from the decode graph (1D rotary) and the
    speculative macro step. JAX's decode and verify tile one position over
    the three streams, which is this equality."""
    _, tcfg, _, tp = stacks
    inp = prompt_inputs(0, tcfg.hidden_size)[1]
    pos1 = np.arange(inp.input_embeds.shape[0], dtype=np.int32)
    e1 = CompressionEngine(tp, tcfg.replace(mrope_section=None), FrameFusionConfig(**FF), attn_impl="einsum")
    e3 = CompressionEngine(tp, tcfg, FrameFusionConfig(**FF), attn_impl="einsum")
    args = prefill_args(inp)
    r1 = e1.prefill(args[0], args[1], pos1, *args[3:])
    r3 = e3.prefill(args[0], args[1], np.tile(pos1, (3, 1)), *args[3:])
    assert events(r1) == events(r3) and torch.equal(r1.logits, r3.logits)
    assert (r1.pos_dims, r3.pos_dims) == (1, 3)
    assert r1.decode_pos_base == lens(r1)[0] and r3.decode_pos_base == len(pos1)
    r1 = dataclasses.replace(r1, decode_pos_base=r3.decode_pos_base)
    assert e1.generate(r1, 6) == e3.generate(r3, 6)
    assert e1.generate_spec(r1, 6, draft_len=2) == e3.generate_spec(r3, 6, draft_len=2)
    tiled = tq.token_cos_sin(torch.full((5, 3), 77, dtype=torch.int64), tcfg)
    for got, want in zip(tiled, tq.positions_cos_sin(torch.full((5,), 77, dtype=torch.int64), tcfg)):
        assert torch.equal(got, want)


# -- the adapter and the tower's host side ------------------------------------------------


@pytest.mark.parametrize("grid,video_start,total_extra,spgt", [
    ((2, 4, 4), 4, 2, None), ((1, 2, 2), 0, 5, None), ((3, 4, 8), 7, 0, None), ((32, 26, 34), 15, 14, None),
    ((2, 4, 4), 4, 2, 0.5), ((3, 4, 8), 2, 5, 1.0), ((4, 8, 4), 6, 3, 2.0)])
def test_mrope_position_ids_match_jax(grid, video_start, total_extra, spgt):
    """Text, video grid and the text after it, with and without the
    Qwen2.5-VL temporal spacing (``second_per_grid_ts``, fractional seconds
    truncated): EQUAL."""
    t, h, w = grid
    total = video_start + t * (h // 2) * (w // 2) + total_extra
    kw = dict(second_per_grid_ts=spgt, tokens_per_second=4) if spgt is not None else {}
    got = tad.mrope_position_ids(total, video_start, t, h, w, **kw)
    want = jad.mrope_position_ids(total, video_start, t, h, w, **kw)
    assert got.dtype == want.dtype and got.shape == (3, total)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spgt", [None, 2.0])
def test_build_prefill_inputs_matches_jax(spgt):
    text, video, at = qwen_prompt(5, 16)
    want = jad.build_prefill_inputs(text, video, at, *GRID, second_per_grid_ts=spgt)
    got = tad.build_prefill_inputs(text, video, at, *GRID, second_per_grid_ts=spgt)
    for name in ("input_embeds", "patch_type", "position_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("patch_num", "image_token_start", "image_token_length", "num_importance_queries"):
        assert getattr(got, name) == getattr(want, name)
    assert got.num_importance_queries == 4 and got.patch_num == 6
    feats = torch.from_numpy(video)  # tensors splice on their device
    spliced = tad.build_prefill_inputs(torch.from_numpy(text), feats, at, *GRID).input_embeds
    np.testing.assert_array_equal(spliced.numpy(), want.input_embeds)
    with pytest.raises(ValueError, match="do not match the grid"):
        tad.build_prefill_inputs(text, video[:-1], at, *GRID)


@pytest.mark.parametrize("n_frames,h,w", [(4, 28, 28), (3, 28, 56), (5, 56, 28)])
def test_pixels_to_patches_and_vision_rope_match_jax(n_frames, h, w):
    """The processor layout (an odd frame count repeats the last frame) and
    the 2D vision rotary of the merge-block order: EQUAL."""
    cfg_j, cfg_t = jvit.tiny_qwen2vl_vit_config(), tvit.tiny_qwen2vl_vit_config()
    frames = np.random.default_rng(n_frames).standard_normal((n_frames, h, w, 3)).astype(np.float32)
    got, grid = tvit.pixels_to_patches(frames, cfg_t)
    want, grid_j = jvit.pixels_to_patches(frames, cfg_j)
    assert grid == grid_j and grid[0] == -(-n_frames // 2)
    np.testing.assert_array_equal(got, want)
    for g, wv in zip(tvit.vision_rope_cos_sin(grid[1], grid[2], cfg_t), jvit.vision_rope_cos_sin(grid[1], grid[2], cfg_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    with pytest.raises(ValueError, match="multiple of patch"):
        tvit.pixels_to_patches(frames[:, :20], cfg_t)


# -- the tower --------------------------------------------------------------------------


TOWERS = {"tiny": {}, "hd80": dict(embed_dim=160, num_heads=2, hidden_size=48)}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_encode_video_matches_jax(tower):
    """Tiny towers (head dim 16, and 80 as Qwen2-VL-7B's), fp32: the port's
    "flash" (kernel E's plain version) and "einsum" paths against JAX's
    einsum path within TOWER_TOL of the largest feature."""
    cfg_j = jvit.tiny_qwen2vl_vit_config(**TOWERS[tower])
    cfg_t = tvit.tiny_qwen2vl_vit_config(**TOWERS[tower])
    assert cfg_t.head_dim == cfg_j.head_dim == (80 if tower == "hd80" else 16)
    jp = jvit.init_params(cfg_j, jax.random.PRNGKey(4))
    tp = tq.params_from_numpy(jax.device_get(jp), device="cpu")
    frames = np.random.default_rng(4).standard_normal((5, 28, 42, 3)).astype(np.float32)
    patches, grid = jvit.pixels_to_patches(frames, cfg_j)
    want = np.asarray(jvit.encode_video(jp, jnp.asarray(patches), *grid, cfg_j, attn_impl="einsum"))
    assert want.shape == (grid[0] * grid[1] * grid[2] // 4, cfg_j.hidden_size)
    for impl in ("flash", "einsum"):
        got = tvit.encode_video(tp, patches, *grid, cfg_t, attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=TOWER_TOL * np.abs(want).max(), err_msg=impl)
    with pytest.raises(ValueError, match="do not match the grid"):
        tvit.encode_video(tp, patches[:-1], *grid, cfg_t)


# -- the engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "planned", "segmented", "dense"])
def test_prefill_and_generate_match_jax(engines, mode):
    """Each executor on mRoPE positions: events, cache lengths (the keep
    sets' sizes) and the decode base (max(positions) + 1) EQUAL JAX's, the
    live rows' layer-0 keys (the keep set itself) and the logits to
    tolerance, then 6 greedy tokens EQUAL JAX's."""
    eng_j, eng_t, eng_f = engines
    inp_j, inp_t = prompt_inputs(1, eng_t.cfg.hidden_size)
    res_j = eng_j.prefill(*prefill_args(inp_j), mode=mode)
    res_t = eng_t.prefill(*prefill_args(inp_t), mode=mode)
    assert res_t.mode == res_j.mode and res_t.valid_len == res_j.valid_len
    if mode != "dense":
        assert events(res_t) == events(res_j)
        assert any(e[1] == "prune" for e in events(res_t)) and any(e[1] == "merge" and e[2] for e in events(res_t))
    assert lens(res_t) == [int(c[2]) for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base == int(inp_t.position_ids.max()) + 1
    assert res_t.pos_dims == res_j.pos_dims == 3
    n0 = lens(res_t)[0]
    k_j = np.asarray(res_j.layer_caches[0][0])[:n0]
    np.testing.assert_allclose(res_t.layer_caches[0][0][:n0].numpy(), k_j, atol=LOGIT_TOL * np.abs(k_j).max())
    assert_logits(res_t.logits, res_j.logits)
    assert eng_t.generate(res_t, 6) == eng_j.generate_greedy(res_j, 6)


def test_planned_batch_and_generate_batch_match_jax(engines):
    """The lockstep batch over three mRoPE prompts and one batched decode:
    events, cache lengths, decode bases and tokens EQUAL JAX's."""
    eng_j, eng_t, eng_f = engines
    pairs = [prompt_inputs(s, eng_t.cfg.hidden_size, coherent=c) for s, c in ((2, 0.45), (3, 0.3), (4, 0.6))]

    def batch(inputs):
        return [(i.input_embeds, i.patch_type, i.position_ids, i.image_token_start, i.image_token_length)
                for i in inputs]

    res_j = eng_j.prefill_planned_batch(batch([p[0] for p in pairs]), patch_num=6)
    res_t = eng_t.prefill_planned_batch(batch([p[1] for p in pairs]), patch_num=6)
    for rt, rj in zip(res_t, res_j):
        assert (rt.mode, events(rt), lens(rt), rt.decode_pos_base) == \
               (rj.mode, events(rj), [int(c[2]) for c in rj.layer_caches], rj.decode_pos_base)
        assert_logits(rt.logits, rj.logits)
    assert eng_t.generate_batch(res_t, 6) == eng_j.generate_batch(res_j, 6)
    with pytest.raises(ValueError, match="mixed rope layouts"):
        args = batch([pairs[0][1]])[0]
        eng_t.prefill_planned_batch([args, (args[0], args[1], np.arange(len(args[1])), *args[3:])], patch_num=6)


def test_speculative_and_serving_match_jax(engines):
    """``generate_spec`` (drafts from the plain decode: accepted) and
    ``generate_spec_batch`` on mRoPE results, and the serving loop over
    three mRoPE requests (its chunk step decodes 1D at each slot's base):
    tokens and stats EQUAL JAX's."""
    eng_j, eng_t, eng_f = engines
    pairs = [prompt_inputs(s, eng_t.cfg.hidden_size) for s in (5, 6, 7)]
    res_j = [eng_j.prefill(*prefill_args(p[0])) for p in pairs]
    res_t = [eng_t.prefill(*prefill_args(p[1])) for p in pairs]
    plain = eng_t.generate(res_t[0], 12)
    pids = np.asarray(plain, np.int32)
    got = eng_t.generate_spec(res_t[0], 12, draft_len=3, prompt_ids=pids, return_stats=True)
    assert got == eng_j.generate_spec(res_j[0], 12, draft_len=3, prompt_ids=pids, return_stats=True)
    assert got[0] == plain and got[1]["accepted"] > 0
    assert eng_t.generate_spec_batch(res_t[:2], 8, draft_len=2) == eng_j.generate_spec_batch(res_j[:2], 8, draft_len=2)
    res_f = [eng_f.prefill(*prefill_args(p[1])) for p in pairs[:2]]
    assert eng_f.generate_spec_batch(res_f, 8, draft_len=2) == eng_f.generate_batch(res_f, 8)

    kw = dict(max_slots=2, max_new_cap=12, chunk_steps=3, prefix_cap=256, draft_len=2)
    loop_j, loop_t = JaxLoop(eng_j, **kw), ServingLoop(eng_t, **kw)
    assert loop_t.pos_dims == loop_j.pos_dims == 3
    budgets = (10, 5, 12)
    ids_j = [loop_j.submit(JaxRequest(p[0], max_new_tokens=n)) for p, n in zip(pairs, budgets)]
    ids_t = [loop_t.submit(ServeRequest(p[1], max_new_tokens=n)) for p, n in zip(pairs, budgets)]
    out_j, out_t = loop_j.run(), loop_t.run()
    got = [(out_t[i].tokens, out_t[i].admitted_step) for i in ids_t]
    assert got == [(out_j[i].tokens, out_j[i].admitted_step) for i in ids_j]
    assert got[0][0] == eng_t.generate(res_t[0], 10)
    one_d = PrefillInputs(**{**vars(pairs[0][1]), "position_ids": np.arange(len(pairs[0][1].patch_type))})
    loop = ServingLoop(eng_t, **kw)
    loop.submit(ServeRequest(one_d, max_new_tokens=4))
    with pytest.raises(ValueError, match="rope layout"):
        loop.run()


@pytest.mark.parametrize("mode,kw", [("fastv", dict(fastv_k=2, fastv_r=0.5)),
                                     ("streamingllm", dict(init_num=4, length_rate=0.5)),
                                     ("merge_then_fastv", dict(sparsity=[0.2] * 4, fastv_k=2, fastv_r=0.5))])
def test_baselines_match_jax(stacks, mode, kw):
    """FastV's compaction, StreamingLLM's sink + window prefill and the
    merging family's segments on mRoPE positions: events, cache lengths and
    decode base EQUAL JAX's, logits to tolerance, 5 tokens EQUAL
    (StreamingLLM at a bucket multiple: JAX reads the last row of the padded
    prompt, ROADMAP Queue 3)."""
    jcfg, tcfg, jp, tp = stacks
    # 5 text rows, 36 video rows, then 87 text rows: 128 tokens, the bucket
    inp_j, inp_t = prompt_inputs(8, tcfg.hidden_size, n_post=87 if mode == "streamingllm" else 6)
    eng_j = JaxBaselineEngine(jp, jcfg, mode, kw, attn_impl="einsum")
    eng_t = BaselineEngine(tp, tcfg, mode, kw, attn_impl="einsum")
    res_j, res_t = eng_j.prefill(*prefill_args(inp_j)), eng_t.prefill(*prefill_args(inp_t))
    assert events(res_t) == events(res_j) and lens(res_t) == [int(c[2]) for c in res_j.layer_caches]
    assert res_t.decode_pos_base == res_j.decode_pos_base == int(inp_t.position_ids.max()) + 1
    assert_logits(res_t.logits, res_j.logits)
    assert eng_t.generate(res_t, 5) == eng_j.generate_greedy(res_j, 5)
