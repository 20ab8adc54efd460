"""Plain attention ops: causal prefill, last-rows importance, decode, verify.

Port of ``framefusion_tpu.ops.attention``. These are the reference paths
(full score materialisation, fp32); the hand-written CUDA prefill kernels
live in ``ops/kernels/flash_prefill.py``.

``last_rows_importance`` keeps the live-rank capture rule: in the mask-only
layout the last ``num`` LIVE rows are selected by live rank, because dead
tokens can sit inside the trailing window. Without ``key_valid`` the layout
is compacted and the trailing window ``[valid_len - num, valid_len)`` is
exact.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _gqa_expand(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """(S, Hq, D) -> (Hk, G, S, D) grouped layout (HF repeat_kv order)."""
    s, hq, d = q.shape
    return q.reshape(s, num_kv_heads, hq // num_kv_heads, d).permute(1, 2, 0, 3)


def causal_attention_einsum(q, k, v, key_valid=None) -> torch.Tensor:
    """Reference attention. q: (S, Hq, D); k, v: (S, Hk, D) -> (S, Hq, D).

    ``key_valid`` (S,) bool masks out dead keys (the mask-only compression
    phase keeps merged/pruned tokens in place until one compaction).
    """
    s, hq, d = q.shape
    hk = k.shape[1]
    qg = _gqa_expand(q, hk).to(torch.float32)
    kf = k.permute(1, 0, 2).to(torch.float32)
    vf = v.permute(1, 0, 2).to(torch.float32)
    scores = torch.einsum("hgsd,htd->hgst", qg, kf) / math.sqrt(d)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    if key_valid is not None:
        mask = mask & key_valid[None, :]
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgst,htd->hgsd", probs, vf)
    return out.permute(2, 0, 1, 3).reshape(s, hq, d).to(q.dtype)


def capture_rows(s: int, num: int, valid_len, key_valid=None, device=None) -> torch.Tensor:
    """(num,) int64 positions of the importance-capture rows, ascending.

    With ``key_valid`` the rows are the last ``num`` live positions (by live
    rank); fewer than ``num`` live rows leave leading -1 sentinels, which
    contribute zero. Without it they are ``[valid_len - num, valid_len)``.
    """
    if key_valid is not None:
        positions = torch.arange(s, device=key_valid.device)
        live_rank = torch.cumsum(key_valid.to(torch.int64), dim=0)
        wanted = key_valid & (live_rank > live_rank[-1] - num)
        return torch.sort(torch.where(wanted, positions, torch.full_like(positions, -1))).values[-num:]
    rows = torch.as_tensor(valid_len, device=device).to(torch.int64) - num + torch.arange(num, device=device)
    return torch.where(rows >= 0, rows, torch.full_like(rows, -1))


def last_rows_importance(q, k, num: int, valid_len, scale=None, key_valid=None) -> torch.Tensor:
    """Mean attention mass of the last ``num`` LIVE query rows over all keys.

    Args:
        q: (S, Hq, D); k: (S, Hk, D); valid_len: live length (compacted
            layouts); key_valid: (S,) bool for the mask-only layout.

    Returns:
        (S,) fp32 softmax probabilities averaged over heads and the ``num``
        rows; zero beyond each row's causal horizon and at dead keys.
    """
    s, hq, d = q.shape
    hk = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    rows = capture_rows(s, num, valid_len, key_valid, device=q.device)
    row_live = rows >= 0
    row_pos = torch.clamp(rows, min=0)
    q_rows = q[row_pos].to(torch.float32)  # (num, Hq, D)
    q_rows = q_rows.reshape(num, hk, hq // hk, d).permute(1, 2, 0, 3)  # (Hk, G, num, D)
    kf = k.permute(1, 0, 2).to(torch.float32)
    scores = torch.einsum("hgnd,hkd->hgnk", q_rows, kf) * scale
    key_pos = torch.arange(s, device=q.device)
    mask = key_pos[None, :] <= row_pos[:, None]
    if key_valid is not None:
        mask = mask & key_valid[None, :]
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(row_live[None, None, :, None], probs, torch.zeros_like(probs))
    return probs.sum(dim=2).mean(dim=(0, 1)) / num


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single-token decode attention against a padded cache.

    Args:
        q: (Hq, D); k_cache, v_cache: (S_pad, Hk, D); cache_len: valid
            entries, the current token included: an int, or a 0-d or
            one-element integer tensor on q's device (the mask is then a
            tensor compare, with no read to the host).
    Returns:
        (Hq, D) in q's dtype.
    """
    s_pad, hk, d = k_cache.shape
    hq = q.shape[0]
    qf = q.reshape(hk, hq // hk, d).to(torch.float32)
    kf = k_cache.permute(1, 0, 2).to(torch.float32)
    vf = v_cache.permute(1, 0, 2).to(torch.float32)
    scores = torch.einsum("hgd,hkd->hgk", qf, kf) / math.sqrt(d)
    mask = torch.arange(s_pad, device=q.device) < cache_len
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgk,hkd->hgd", probs, vf)
    return out.reshape(hq, d).to(q.dtype)


def verify_attention(q, k_cache, v_cache, base_len: int) -> torch.Tensor:
    """Multi-row decode attention for speculative verification.

    The caller has written the K rows' keys/values at positions
    ``base_len .. base_len + K - 1``; row ``i`` attends the prefix plus rows
    ``0..i``. Row 0 is the same masked fp32 softmax as
    :func:`decode_attention`, so a verify step with no accepted drafts
    reproduces the decode step.

    Args:
        q: (K, Hq, D); k_cache, v_cache: (S_pad, Hk, D); base_len: valid
            entries before these K rows.
    Returns:
        (K, Hq, D) in q's dtype.
    """
    s_pad, hk, d = k_cache.shape
    kq, hq = q.shape[0], q.shape[1]
    qf = q.reshape(kq, hk, hq // hk, d).to(torch.float32)
    kf = k_cache.permute(1, 0, 2).to(torch.float32)
    vf = v_cache.permute(1, 0, 2).to(torch.float32)
    scores = torch.einsum("nhgd,hkd->nhgk", qf, kf) / math.sqrt(d)
    horizon = base_len + 1 + torch.arange(kq, device=q.device)
    mask = torch.arange(s_pad, device=q.device)[None, :] < horizon[:, None]
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("nhgk,hkd->nhgd", probs, vf)
    return out.reshape(kq, hq, d).to(q.dtype)


def causal_attention(q, k, v, impl: str, key_valid=None) -> torch.Tensor:
    """Causal GQA prefill attention by ``impl``: ``"einsum"`` is the plain
    fp32 version above; ``"flash"`` (and JAX's name for its kernel,
    ``"pallas"``) is kernel A (``ops/kernels/flash_prefill``), which runs its
    plain version for CPU tensors. JAX's ``"chunked"`` is its memory-bounded
    path for backends other than the TPU; the port does not have it (the
    CPU runs the plain einsum, the card kernel A) and raises."""
    if impl == "einsum":
        return causal_attention_einsum(q, k, v, key_valid=key_valid)
    if impl in ("flash", "pallas"):
        from .kernels.flash_prefill import flash_causal_attention

        return flash_causal_attention(q, k, v, key_valid=key_valid)
    if impl == "chunked":
        raise NotImplementedError('impl="chunked" is JAX\'s memory-bounded path off the TPU and is not ported: '
                                  'use "einsum" on the CPU, "flash" on the card')
    raise ValueError(f"unknown attention impl: {impl}")
