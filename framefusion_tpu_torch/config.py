"""Configuration dataclasses (PyTorch port of ``framefusion_tpu.config``).

``FrameFusionConfig`` carries the three public knobs of
``apply_framefusion(model, cost, similarity_lower_bound, ratio_lower_bound)``
plus the static planning knobs (shape buckets, importance rows, the
scheduler's layer count). ``LLMConfig`` describes the Qwen2-family decoder
stack (``mrope_section`` set for Qwen2-VL's multimodal rotary; no qkv bias
for InternLM2; ``num_experts > 0`` for the Qwen2-MoE sparse MLP); its
``dtype`` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FrameFusionConfig:
    cost: float = 0.3
    similarity_lower_bound: float = 0.6
    ratio_lower_bound: float = 0.1
    # Trailing query rows whose attention scores token importance: 1 for
    # Qwen2-family stacks, 4 for Qwen2-VL.
    num_importance_queries: int = 1
    # Layer count used by the cost scheduler (the reference hard-codes 28).
    schedule_num_layers: int = 28
    # Shape-bucket granularity for compacted sequences.
    bucket: int = 128

    def replace(self, **kw) -> "FrameFusionConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    """Decoder-stack geometry (the Qwen2 / Qwen2-VL / InternLM2 decoders)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = False
    qkv_bias: bool = True
    dtype: torch.dtype = torch.bfloat16
    # mRoPE section sizes over the head_dim/2 frequency slots (Qwen2-VL);
    # None: standard 1D RoPE.
    mrope_section: Optional[tuple] = None
    # Qwen2-MoE sparse MLP (num_experts == 0: the dense SwiGLU MLP), as HF
    # Qwen2MoeConfig: softmax router, top-k experts (optionally
    # renormalised) and a shared expert behind a sigmoid gate.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = False
    # Prefill's per-expert token budget: ceil(S * top_k / E) times this
    # (models/moe.moe_prefill_capacity); decode reads the routed experts'
    # weights and has no capacity.
    moe_capacity_factor: float = 1.25

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    def replace(self, **kw) -> "LLMConfig":
        return dataclasses.replace(self, **kw)


def tiny_llm_config(**kw) -> LLMConfig:
    """Small geometry for tests: real code paths, fast runs."""
    base = dict(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=1e4,
        dtype=torch.float32,
    )
    base.update(kw)
    return LLMConfig(**base)


def tiny_moe_llm_config(**kw) -> LLMConfig:
    """Small Qwen2-MoE stack for tests: 4 experts, top-2, a shared expert."""
    base = dict(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=0,
        num_layers=4,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=1e4,
        dtype=torch.float32,
        num_experts=4,
        num_experts_per_tok=2,
        moe_intermediate_size=96,
        shared_expert_intermediate_size=160,
    )
    base.update(kw)
    return LLMConfig(**base)


def qwen2_moe_a14b_config(**kw) -> LLMConfig:
    """Qwen2-57B-A14B geometry (``Qwen/Qwen2-57B-A14B`` config.json): 28
    layers, hidden 3584, GQA 28 / 4, 64 experts of width 2560, top-8
    softmax routing, a shared expert of width 20480, vocab 151936."""
    base = dict(
        vocab_size=151936,
        hidden_size=3584,
        intermediate_size=0,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1e6,
        num_experts=64,
        num_experts_per_tok=8,
        moe_intermediate_size=2560,
        shared_expert_intermediate_size=20480,
        norm_topk_prob=False,
    )
    base.update(kw)
    return LLMConfig(**base)


def qwen2_7b_config(**kw) -> LLMConfig:
    """Qwen2-7B geometry — the LLaVA-Video-7B-Qwen2 backbone."""
    base = dict(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1e6,
    )
    base.update(kw)
    return LLMConfig(**base)


def qwen2_vl_7b_config(**kw) -> LLMConfig:
    """Qwen2-VL-7B-Instruct LLM geometry: Qwen2-7B's decoder with mRoPE
    sections t16 / h24 / w24 over head_dim 128."""
    base = dict(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        rope_theta=1e6,
        mrope_section=(16, 24, 24),
    )
    base.update(kw)
    return LLMConfig(**base)


def qwen25_vl_72b_config(**kw) -> LLMConfig:
    """Qwen2.5-VL-72B-Instruct LLM geometry: 80 layers, hidden 8192, GQA 64
    / 8 (head dim 128), intermediate 29568, mRoPE t16 / h24 / w24. Its bf16
    weights (~145 GB) exceed one card: pass ``num_layers`` to cut the depth.
    Qwen2.5-VL-7B has no preset of its own: its LLM is
    ``qwen2_vl_7b_config()``, its tower ``Qwen25VLViTConfig()``."""
    base = dict(
        vocab_size=152064,
        hidden_size=8192,
        intermediate_size=29568,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        rope_theta=1e6,
        mrope_section=(16, 24, 24),
    )
    base.update(kw)
    return LLMConfig(**base)


def internlm2_8b_config(**kw) -> LLMConfig:
    """InternLM2.5-7B geometry (the InternVL2.5-8B backbone): 32 layers,
    hidden 4096, GQA 32 / 8 (head dim 128), intermediate 14336, vocab 92553,
    no qkv bias."""
    base = dict(
        vocab_size=92553,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rope_theta=1e6,
        qkv_bias=False,
    )
    base.update(kw)
    return LLMConfig(**base)


def qwen2_1_5b_config(**kw) -> LLMConfig:
    """Qwen2-1.5B geometry (LLaVA-OneVision's small backbone): 28 layers,
    hidden 1536, GQA 12 / 2 (head dim 128), intermediate 8960, tied
    embeddings."""
    base = dict(
        vocab_size=151936,
        hidden_size=1536,
        intermediate_size=8960,
        num_layers=28,
        num_heads=12,
        num_kv_heads=2,
        rope_theta=1e6,
        tie_word_embeddings=True,
    )
    base.update(kw)
    return LLMConfig(**base)
