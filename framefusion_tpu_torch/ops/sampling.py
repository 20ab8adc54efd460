"""Token sampling: greedy, temperature, top-k, top-p (port of
``framefusion_tpu.ops.sampling``). Random draws come from an explicit
``torch.Generator``; they do not reproduce ``jax.random``'s bits, so tests
compare greedy tokens exactly and sampled tokens by validity only."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None


def sample_token(logits: torch.Tensor, cfg: SamplerConfig,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample one token id (int64 scalar tensor, on logits' device) from (V,) logits."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits)
    logits = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k is not None:
        kth = torch.topk(logits, cfg.top_k).values[-1]
        logits = torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)
    if cfg.top_p is not None:
        sorted_logits = torch.sort(logits, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p; keep at least one token
        cutoff_idx = torch.clamp((cum < cfg.top_p).sum(), max=logits.shape[0] - 1)
        logits = torch.where(logits < sorted_logits[cutoff_idx], torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[0]
