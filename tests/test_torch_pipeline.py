"""The port's ``TextPipeline`` vs the JAX package's: pixels (or features) to
answer, on the same weights.

The LLM, the SigLIP tower and the projector are drawn by the JAX package
from seeds and carried over with ``params_from_numpy``; prompts go through
the stub tokenizer of tests/test_pipeline.py. Both sides run fp32 on the
CPU (the port's kernel wrappers run their plain versions), so compression
events, per-layer cache lengths, prompt ids and greedy tokens (the answer
text) must be EQUAL; the spliced prefill embeddings agree to 1e-5 (the same
fp32 tower and frontend, summed in other orders).
"""

import jax
import numpy as np
import pytest
import torch

from checkpoint_fixtures import write_fixture
from framefusion_tpu.config import tiny_llm_config as jax_tiny
from framefusion_tpu.interface import FrameFusionModel as JaxModel
from framefusion_tpu.interface import apply_framefusion as jax_apply
from framefusion_tpu.models import qwen2 as jq
from framefusion_tpu.models.vision import llava_frontend as jlf
from framefusion_tpu.models.vision import siglip as js
from framefusion_tpu.pipeline import TextPipeline as JaxPipeline
from framefusion_tpu_torch import preprocess as tpp
from framefusion_tpu_torch.config import tiny_llm_config
from framefusion_tpu_torch.interface import FrameFusionModel, apply_framefusion
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.models.vision import llava_frontend as tlf
from framefusion_tpu_torch.models.vision import siglip as ts
from framefusion_tpu_torch.pipeline import DEFAULT_TEMPLATE, TextPipeline
from test_pipeline import StubTokenizer

TOL = 1e-5


def events(res):
    return [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in res.telemetry.events]


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) over the same tiny LLM, tower and projector."""
    jcfg = jax_tiny(num_layers=4)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    vcfg = js.tiny_vit_config()
    vit = js.init_params(vcfg, jax.random.PRNGKey(1))
    proj = jlf.init_projector(jax.random.PRNGKey(2), vcfg.hidden_size, jcfg.hidden_size)
    jm = jax_apply(JaxModel(family="llava_video", cfg=jcfg, params=jp, attn_impl="einsum"), 0.5, 0.8, 0.05)
    jm.ff = jm.ff.replace(schedule_num_layers=jcfg.num_layers)
    tcfg = tiny_llm_config(num_layers=4)
    tm = apply_framefusion(FrameFusionModel(family="llava_video", cfg=tcfg,
                                            params=tq.params_from_numpy(jax.device_get(jp))), 0.5, 0.8, 0.05)
    tm.ff = tm.ff.replace(schedule_num_layers=tcfg.num_layers)
    jpipe = JaxPipeline(model=jm, tokenizer=StubTokenizer(), vit_params=vit, vit_cfg=vcfg, projector=proj)
    tpipe = TextPipeline(model=tm, tokenizer=StubTokenizer(), vit_params=ts.params_from_numpy(jax.device_get(vit)),
                         vit_cfg=ts.tiny_vit_config(), projector=tlf.params_from_numpy(jax.device_get(proj)))
    return jpipe, tpipe


def _uint8_frames(seed, n=6, h=45, w=61):
    """Camera-sized frames of one scene drifting slowly: adjacent frames are
    alike, so the merge has work to do."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    frames = [base + rng.normal(0, 2 + 12 * (i % 3), base.shape) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def assert_same_answer(jpipe, tpipe, **kw):
    answer_j = jpipe.ask("What happens in the video?", max_new_tokens=6, **kw)
    answer_t = tpipe.ask("What happens in the video?", max_new_tokens=6, **kw)
    res_j, res_t = jpipe.last_result, tpipe.last_result
    assert events(res_t) == events(res_j) and len(events(res_t)) >= 1
    assert [c[2] for c in res_t.layer_caches] == [c[2] for c in res_j.layer_caches]
    assert tpipe.last_prompt_ids == jpipe.last_prompt_ids
    assert answer_t == answer_j
    return answer_t


def test_ask_uint8_frames_matches_jax(pipes):
    jpipe, tpipe = pipes
    frames = _uint8_frames(3)
    answer = assert_same_answer(jpipe, tpipe, frames=frames)
    assert tpipe.last_result.telemetry.vision_token_reduction > 0
    # the spliced prefill inputs agree too
    inp_j = jpipe.build_inputs("Q?", frames=frames)
    inp_t = tpipe.build_inputs("Q?", frames=frames)
    np.testing.assert_allclose(inp_t.input_embeds.numpy(), inp_j.input_embeds, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(inp_t.patch_type, inp_j.patch_type)
    # the explicitly preprocessed float frames give the same answer
    pre = tpp.preprocess_frames(frames, "llava_video", target=(28, 28))
    assert tpipe.ask("What happens in the video?", frames=pre, max_new_tokens=6) == answer


def test_ask_precomputed_features_matches_jax(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(1)
    base = rng.standard_normal((6, 128)).astype(np.float32) * 0.05
    feats = np.concatenate([base + 0.01 * rng.standard_normal(base.shape).astype(np.float32) for _ in range(5)])
    assert_same_answer(jpipe, tpipe, video_features=feats)
    before, _, after = DEFAULT_TEMPLATE.format(question="What happens in the video?").partition("<image>")
    assert tpipe.last_prompt_ids == StubTokenizer().encode(before) + StubTokenizer().encode(after)


class ChatTemplateTokenizer(StubTokenizer):
    """A tokenizer that carries its own chat template (tokenizer_config.json style)."""

    chat_template = "custom"

    def apply_chat_template(self, messages, tokenize, add_generation_prompt):
        return f"<user>{messages[0]['content']}</user><bot>"


def test_tokenizer_chat_template_matches_jax(pipes):
    jpipe, tpipe = pipes
    feats = np.random.default_rng(2).standard_normal((18, 128)).astype(np.float32) * 0.05
    ids = []
    for pipe in (jpipe, tpipe):
        tok = pipe.tokenizer
        pipe.tokenizer = ChatTemplateTokenizer()
        try:
            pipe.build_inputs("Why?", video_features=feats)
        finally:
            pipe.tokenizer = tok
        ids.append(pipe.last_prompt_ids)
    assert ids[1] == ids[0] == ChatTemplateTokenizer().encode("<user>") + ChatTemplateTokenizer().encode(
        "\nWhy?</user><bot>")


def test_from_checkpoint_matches_jax(tmp_path):
    """Hub dir -> ask() in one call (AutoTokenizer over the fixture's
    tokenizer.json, no network), fp32 on both sides."""
    import jax.numpy as jnp

    path = write_fixture(tmp_path, "llava_video")
    jpipe = JaxPipeline.from_checkpoint(path, cost=0.8, dtype=jnp.float32)
    tpipe = TextPipeline.from_checkpoint(path, cost=0.8, dtype=torch.float32)
    for pipe in (jpipe, tpipe):
        pipe.model.ff = pipe.model.ff.replace(schedule_num_layers=pipe.model.cfg.num_layers)
    assert tpipe.model.family == "llava_video" and tpipe.vit_params is not None
    assert tpipe.model.ff.similarity_lower_bound == 0.6
    rng = np.random.default_rng(0)
    base = rng.standard_normal((1, 28, 28, 3)).astype(np.float32)
    frames = np.concatenate([base + 0.02 * rng.standard_normal(base.shape) for _ in range(4)]).astype(np.float32)
    assert_same_answer(jpipe, tpipe, frames=frames)


def test_unported_paths_raise(pipes):
    _, tpipe = pipes
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tpipe.ask("Q?", video_features=np.zeros((18, 128), np.float32), speculative=True)
    other = TextPipeline(model=FrameFusionModel(family="internvl", cfg=tpipe.model.cfg, params=tpipe.model.params),
                         tokenizer=StubTokenizer())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        other.ask("Q?", video_features=np.zeros((18, 128), np.float32))
    with pytest.raises(ValueError, match="vision tower"):
        TextPipeline(model=tpipe.model, tokenizer=StubTokenizer()).ask("Q?", frames=_uint8_frames(0, n=2))
