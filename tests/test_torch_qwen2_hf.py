"""The port's 1D Qwen2 decoder against HuggingFace ``Qwen2ForCausalLM``, and
the int8 LM head.

A tiny random HF model (fp32, CPU; ``tests/test_qwen2_vs_hf.py``'s
geometry) is imported through ``weights.params_from_state_dict``; the
port's dense prefill logits agree with HF's to 2e-4 and its greedy tokens
(the decode step, plain path) are HF's ``generate``'s.

The int8 head: kernel C as a one-layer stack (its plain version here) times
the quantized head equals ``mm`` on the dequantized head to the bf16 bound
(C rounds the row to bf16; the scales factor out exactly), at a Qwen2-like
vocabulary and at an odd one (1,001 columns, InternLM2's 92,553 in small),
which ``ops/quant.quantize_head`` pads to a multiple of 16 columns with
zeros that ``final_logits`` cuts off; the engine's decode then runs on it.
"""

import os

# transformers loads TensorFlow and Flax when it finds them, which doubles
# its import time; these tests use its PyTorch models only.
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_FLAX", "0")

import numpy as np
import pytest
import torch

from framefusion_tpu_torch.config import FrameFusionConfig, LLMConfig
from framefusion_tpu_torch.models import qwen2 as tq
from framefusion_tpu_torch.ops.kernels import matvec_q8 as tmv
from framefusion_tpu_torch.ops.quant import dequantize_weight, quantize_head, quantize_params_int8
from framefusion_tpu_torch.runtime.engine import CompressionEngine
from framefusion_tpu_torch.weights import params_from_state_dict

# Tiny shapes: one intra-op thread each (pytest-xdist workers share the cores).
torch.set_num_threads(1)

TOL = 2e-4
BF16_TOL = 1e-2  # relative to the largest logit: the row rounded to bf16


@pytest.fixture(scope="module")
def hf_qwen2():
    from transformers import Qwen2Config, Qwen2ForCausalLM

    hf_cfg = Qwen2Config(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                         num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
                         rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
                         attn_implementation="eager")
    torch.manual_seed(0)
    model = Qwen2ForCausalLM(hf_cfg).eval()
    cfg = LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4,
                    num_kv_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6, dtype=torch.float32)
    return model, cfg, params_from_state_dict(model.state_dict(), cfg, device="cpu")


def test_prefill_logits_and_greedy_tokens_match_hf(hf_qwen2):
    """Prefill logits on a 33-token prompt; 8 greedy tokens after the
    17-token prompt of ``tests/test_qwen2_vs_hf.py``'s greedy test (another
    prompt's 7th token is a near tie, 1e-3 apart, that HF's cached decode
    and its own full forward already break differently)."""
    model, cfg, params = hf_qwen2
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=33)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=17)
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids[None])).logits[0]
        hf_new = model.generate(torch.tensor(prompt[None]), max_new_tokens=8, do_sample=False,
                                pad_token_id=0)[0, 17:]
    cos, sin = tq.positions_cos_sin(torch.arange(len(ids)), cfg)
    h, _, _ = tq.run_layers(params, tq.embed(params, torch.as_tensor(ids)), cos, sin, cfg, want_caches=False)
    ours = tq.final_logits(params, h, cfg)
    np.testing.assert_allclose(ours.numpy(), hf_logits.numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(ours.argmax(-1), hf_logits.argmax(-1))
    eng = CompressionEngine(params, cfg, FrameFusionConfig(), attn_impl="einsum")
    res = eng.dense_prefill(tq.embed(params, torch.as_tensor(prompt)), np.arange(len(prompt)))
    assert eng.generate(res, 8) == hf_new.tolist()


@pytest.mark.parametrize("vocab", [256, 1001])
def test_int8_head_on_kernel_c_matches_dequantized_mm(hf_qwen2, vocab):
    """C's plain version as a one-layer stack against ``mm`` on the
    dequantized head, through ``final_logits`` (decode side: ``use_mv``;
    prefill side: ``mm``); an odd vocabulary's head is padded, its logits
    cut back; the engine decodes on it, on the plain path and the kernels'."""
    _, cfg, params = hf_qwen2
    g = torch.Generator().manual_seed(vocab)
    cfg = cfg.replace(vocab_size=vocab)
    params = dict(params, embed=torch.randn((vocab, cfg.hidden_size), generator=g) * 0.02,
                  lm_head=torch.randn((cfg.hidden_size, vocab), generator=g) * 0.05)
    q = quantize_params_int8({**params, "layers": dict(params["layers"])}, quantize_lm_head=True)
    head = q["lm_head"]
    assert head["q8"].shape[1] == -(-vocab // 16) * 16 and head["q8"].shape[1] % 16 == 0
    assert torch.equal(head["q8"], quantize_head(params["lm_head"])["q8"])
    h = torch.randn((3, cfg.hidden_size), generator=g)
    want = tq.final_logits(dict(params, lm_head=dequantize_weight(head)[:, :vocab]), h, cfg)
    on_c = tq.final_logits(q, h, cfg, use_mv=True)
    assert on_c.shape == (3, vocab)
    assert (on_c - want).abs().max() <= BF16_TOL * want.abs().max()
    x = tq.rmsnorm(h, q["final_norm"], cfg.rms_norm_eps)
    assert torch.equal(on_c, tmv.matvec_q8(x.to(torch.bfloat16), head["q8"], head["scale"])[:, :vocab])
    np.testing.assert_allclose(tq.final_logits(q, h, cfg).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    ids = torch.arange(5, 22)
    for impl in ("einsum", "flash"):
        eng = CompressionEngine(q, cfg, FrameFusionConfig(), attn_impl=impl)
        toks = eng.generate(eng.dense_prefill(tq.embed(q, ids), np.arange(len(ids))), 4)
        assert len(toks) == 4 and all(0 <= t < vocab for t in toks)
