"""Configuration dataclasses (PyTorch port of ``framefusion_tpu.config``).

``FrameFusionConfig`` carries the three public knobs of
``apply_framefusion(model, cost, similarity_lower_bound, ratio_lower_bound)``
plus the static planning knobs (shape buckets, importance rows, the
scheduler's layer count). ``LLMConfig`` describes the Qwen2-family decoder
stack; its ``dtype`` is a ``torch.dtype``.
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
    """Decoder-stack geometry (Qwen2 family)."""

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
