"""Token sampling: greedy, temperature, top-k, top-p (port of
``framefusion_tpu.ops.sampling``).

A sampled token is drawn by inverse CDF from a uniform number in [0, 1)
that the caller draws beforehand (``draw_uniforms``, one a token, from an
explicit ``torch.Generator``), as the JAX decode loop splits one key a
token before its scan: the step reads no generator and synchronises with
nothing, so it can be captured in a CUDA graph. The draws do not reproduce
``jax.random``'s bits, nor ``torch.multinomial``'s: tests compare greedy
tokens exactly and sampled tokens by validity only."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None


def draw_uniforms(n, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of shape ``n`` (an int, or a tuple such as
    ``(tokens, rows)`` for a batch) from ``generator`` (drawn on its
    device), on ``device``."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(n, generator=generator, device=gen_device, dtype=torch.float32)
    return u.to(device) if device is not None else u


def filtered_probs(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """fp32 probabilities of (..., V) logits after temperature, top-k and
    top-p, row by row: tokens outside a row's kept set get exactly 0."""
    logits = logits.to(torch.float32) / cfg.temperature
    neg_inf = torch.full_like(logits, float("-inf"))
    if cfg.top_k is not None:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if cfg.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative prob >= top_p; keep at least one token
        cutoff_idx = torch.clamp((cum < cfg.top_p).sum(dim=-1, keepdim=True), max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return torch.softmax(logits, dim=-1)


def sample_token(logits: torch.Tensor, cfg: SamplerConfig, generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (int64, on logits' device) from (..., V) logits: a 0-d id
    from (V,) logits, a (B,) row of ids from (B, V) (the JAX package's
    ``vmap(sample_token)``).

    Greedy is the argmax. Otherwise each row's token is the first, in order
    of falling probability, at which the row's cumulative probability passes
    ``u * total``; ``u`` holds one uniform in [0, 1) a row (logits' leading
    shape, or one element for (V,) logits), on logits' device (drawn from
    ``generator`` when None). Only tokens of positive probability can be
    chosen."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    lead = logits.shape[:-1]
    if u is None:
        u = draw_uniforms(tuple(lead) or 1, generator, logits.device)
    probs = filtered_probs(logits, cfg)
    p_sorted, idx_sorted = torch.sort(probs, dim=-1, descending=True)
    cdf = torch.cumsum(p_sorted, dim=-1)
    target = u.reshape(*lead, 1).to(torch.float32) * cdf[..., -1:]
    j = torch.searchsorted(cdf, target, right=True)
    # the last positive probability bounds the pick against rounding in cdf
    j = torch.minimum(j, (p_sorted > 0).sum(dim=-1, keepdim=True) - 1)
    return idx_sorted.gather(-1, j)[..., 0]
