"""Speculative greedy decoding with prompt-lookup drafts (port of
``framefusion_tpu.runtime.spec_decode``).

A verify pass runs K = draft_len + 1 candidate rows through the stack at
once (``qwen2.verify_step``): row 0 the last committed token, rows 1..K-1
the drafts, which are the tokens that followed the most recent earlier
occurrence of the last two committed tokens in the history (the prompt's
text ids, if the caller has them, then the output). The longest prefix of
drafts equal to the model's own greedy continuation is committed, plus one
bonus token, so the output is exactly the plain greedy decode; a bad draft
costs only speed. Rejected rows stay in the pool as dead padding past the
lengths and the next pass overwrites them.

JAX runs the loop as one ``lax.while_loop`` on ``emitted < max_new``. Here
one macro step is captured as a CUDA graph over static buffers
(``decode_graph.SpecDecodeGraph`` / ``SpecBatchDecodeGraph``; on the CPU the
same body runs eagerly) and ``spec_decode_loop`` / ``spec_decode_loop_batch``
replay it in chunks: each chunk is as many replays as the tokens still to
come could at least take (``ceil(left / K)``), then the host reads one
scalar, ``min(emitted)``. Every replay is gated on the device by the loop's
own condition, so a replay after the end commits nothing, counts nothing
and writes no row.

Kernels C and D read each weight tile once for all of a pass's rows (on
the tensor cores), as the TPU kernel streams the weights once for all rows,
so on the card a K-row pass costs little more than a one-row pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bucket_length
from ..models import qwen2

__all__ = ["draft_lookup", "spec_macro_step", "spec_decode_loop", "spec_decode_loop_batch", "generate_spec",
           "generate_spec_batch"]


def draft_lookup(hist: torch.Tensor, hist_len, draft_len: int):
    """Prompt-lookup drafts: the most recent earlier bigram match.

    Finds the largest p < hist_len - 1 with hist[p-1] == hist[hist_len-2]
    and hist[p] == hist[hist_len-1], and proposes hist[p+1 .. p+draft_len].
    ``hist`` is (H,) or (B, H) with ``hist_len`` () or (B,) (an int or an
    integer tensor on its device). Returns (drafts (..., draft_len), found
    (...) bool); with no match (or hist_len < 3) the drafts are the buffer's
    first rows, harmless, because acceptance compares drafts against the
    model's own greedy tokens.
    """
    cap = hist.shape[-1]
    dev = hist.device
    idx = torch.arange(cap, device=dev)
    prev = torch.cat([hist[..., :1], hist[..., :-1]], dim=-1)  # prev[p] = hist[p-1]
    hl = torch.as_tensor(hist_len, device=dev).to(torch.int64)[..., None]
    last1 = hist.gather(-1, (hl - 1).clamp(0, cap - 1))
    last0 = hist.gather(-1, (hl - 2).clamp(0, cap - 1))
    m = (hist == last1) & (prev == last0) & (idx >= 1) & (idx < hl - 1) & (hl >= 3)
    p = torch.where(m, idx, torch.full_like(idx, -1)).amax(dim=-1, keepdim=True)
    gather = (p + 1 + torch.arange(draft_len, device=dev)).clamp(0, cap - 1)
    return hist.gather(-1, gather), p[..., 0] >= 0


def accepted_drafts(drafts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """How many leading drafts equal the model's greedy tokens ``t`` (..., K)."""
    ok = (drafts == t[..., :-1]).to(torch.int64)
    return torch.cumprod(ok, dim=-1).sum(dim=-1)


def update_rows(buf: torch.Tensor, vals: torch.Tensor, at: torch.Tensor, gate=None) -> None:
    """JAX's ``dynamic_update_slice`` of ``vals`` (..., K) into ``buf`` (...,
    N) at ``at`` (...) along the last axis, in place: the start is clamped
    to [0, N - K] as JAX clamps it. Under a False ``gate`` (0-d bool) the
    rows are written back unchanged."""
    k = vals.shape[-1]
    start = at.clamp(0, buf.shape[-1] - k)
    rows = start[..., None] + torch.arange(k, device=buf.device)
    if gate is not None:
        vals = torch.where(gate, vals, buf.gather(-1, rows))
    buf.scatter_(-1, rows, vals)


def spec_macro_step(params, last, emitted, hist, hist_len, pos_bases, k_pool, v_pool, cache_lens, dmask, base, *,
                    cfg, draft_len: int, attn_impl: str = "flash", tail_split=None, k_tail=None, v_tail=None,
                    phys=None, gate=None):
    """One batched draft-and-verify macro step: the shared core of the
    batched loop and the serving chunk (``ServingLoop._macro_step``). Per
    sequence prompt-lookup drafts (none at ``draft_len == 0``: plain batched
    greedy decode with per-sequence validity bitmaps), one
    ``qwen2.verify_step_batch`` pass writing every sequence's K rows at the
    common offset ``base`` (an int64 scalar tensor; the device form), then
    the model's argmax and the accepted-draft counts. The commit
    bookkeeping stays with the caller. ``gate`` (0-d bool): when False no
    row is written.

    Returns (t (B, K) greedy tokens, a (B,) accepted drafts, found (B,)
    draft-source hits).
    """
    kq = draft_len + 1
    if draft_len > 0:
        drafts, found = draft_lookup(hist, hist_len, draft_len)
        rows = torch.cat([last[:, None], drafts], dim=1)  # (B, K)
    else:
        found = torch.zeros_like(last, dtype=torch.bool)
        rows = last[:, None]
    te = qwen2.embed(params, rows)
    pos = pos_bases[:, None] + (emitted[:, None] - 1) + torch.arange(kq, device=last.device)[None]
    logits = qwen2.verify_step_batch(params, te, pos, k_pool, v_pool, cache_lens, dmask, base, 0, cfg,
                                     attn_impl=attn_impl, tail_split=tail_split, k_tail=k_tail, v_tail=v_tail,
                                     phys=phys, gate=gate)[0]
    t = torch.argmax(logits, dim=-1)  # (B, K)
    a = accepted_drafts(drafts, t) if draft_len > 0 else torch.zeros_like(last)
    return t, a, found


def _chunks(graph, max_new: int, emitted_min) -> None:
    """Replay ``graph`` until ``emitted_min()`` (one scalar read) reaches
    ``max_new``: each chunk ``ceil(left / K)`` replays, the fewest the tokens
    left can take, so no replay runs after the end."""
    while True:
        left = max_new - int(emitted_min())
        if left <= 0:
            return
        graph.run(-(-left // graph.kq))


def spec_decode_loop(graph, max_new: int):
    """Run a started ``SpecDecodeGraph`` to ``max_new`` tokens. Returns
    (tokens (max_new,), macro_steps, drafted, accepted) as device tensors:
    ``accepted / max(drafted, 1)`` is the acceptance rate and ``(max_new -
    1) / macro_steps`` the tokens a weight pass (1 is plain decode)."""
    _chunks(graph, max_new, lambda: graph.emitted)
    return graph.out[:max_new].clone(), graph.steps.clone(), graph.drafted.clone(), graph.accepted.clone()


def spec_decode_loop_batch(graph, max_new: int):
    """Run a started ``SpecBatchDecodeGraph`` until its slowest sequence has
    ``max_new`` tokens (a finished sequence rides on, committing nothing).
    Returns (tokens (B, max_new), macro_steps, drafted (B,), accepted (B,))
    as device tensors."""
    _chunks(graph, max_new, lambda: graph.emitted.min())
    return (graph.out[:, :max_new].clone(), graph.steps.clone(), graph.drafted.clone(),
            graph.accepted.clone())


def history_cap(prompt_lens, max_new: int, draft_len: int) -> int:
    """History buffer length: the longest seed padded to a power of two (at
    least 64, so nearby prompt lengths share a graph) plus the output."""
    seed_cap = max(64, int(2 ** np.ceil(np.log2(max(1, max(prompt_lens, default=0))))))
    return seed_cap + max_new + draft_len + 1


def _ids(prompt_ids) -> np.ndarray:
    return (np.zeros((0,), np.int64) if prompt_ids is None
            else np.asarray(prompt_ids, np.int64).reshape(-1))


def _cut(ids: list, eos_token_id) -> list:
    if eos_token_id is not None and eos_token_id in ids:
        ids = ids[: ids.index(eos_token_id) + 1]
    return ids


def _check(max_new_tokens: int, draft_len: int) -> None:
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be at least 1, got {max_new_tokens}")
    if draft_len < 0:
        raise ValueError(f"draft_len must be at least 0, got {draft_len}")


def generate_spec(engine, result, max_new_tokens: int, draft_len: int = 4, prompt_ids=None, eos_token_id=None,
                  return_stats: bool = False):
    """Greedy decode of ``result`` by draft-and-verify macro steps:
    the pools from ``make_decode_state`` with ``max_new_tokens + draft_len``
    rows of headroom, filled in place into the engine's speculative graph,
    the history seeded from the prompt's text ids when the caller has them
    (video embeddings have no ids), one read of the tokens at the end. The
    tokens are exactly ``generate``'s (greedy). ``return_stats`` adds
    macro_steps, drafted, accepted and tokens_per_pass."""
    _check(max_new_tokens, draft_len)
    pids = _ids(prompt_ids)
    graph = engine.spec_graph(result, max_new_tokens, draft_len, history_cap([len(pids)], max_new_tokens, draft_len))
    graph.busy = True
    try:
        _, _, lens = engine.make_decode_state(result, 0, pools=(graph.k_pool, graph.v_pool))
        graph.start(lens, result.decode_pos_base, result.logits, [pids], max_new_tokens)
        toks, steps, drafted, accepted = spec_decode_loop(graph, max_new_tokens)
        out = [int(t) for t in toks.tolist()]
        steps, drafted, accepted = int(steps), int(drafted), int(accepted)
    finally:
        graph.busy = False
    out = _cut(out, eos_token_id)
    if return_stats:
        return out, {"macro_steps": steps, "drafted": drafted, "accepted": accepted,
                     # token 0 is free (the prefill's logits) in the plain decode too
                     "tokens_per_pass": (max_new_tokens - 1) / max(steps, 1)}
    return out


def generate_spec_batch(engine, results, max_new_tokens: int, draft_len: int = 4, prompt_ids=None,
                        eos_token_id=None, return_stats: bool = False):
    """Batched speculative greedy decode (the speculative sibling of
    ``generate_batch``): one pool bucket for the batch, each sequence's
    caches in its own column, a decode region of ``K * (max_new - 1) + 1``
    rows at ``write_pos = S_pool - region`` (a macro step burns K rows
    whether or not its drafts are accepted), every sequence's K rows
    verified in one weight pass. ``prompt_ids``: one text id list (or None)
    a sequence. The tokens are exactly the plain batched greedy decode's."""
    _check(max_new_tokens, draft_len)
    results = list(results)
    if not results:
        raise ValueError("generate_spec_batch: empty batch")
    seqs = [_ids(p) for p in (prompt_ids if prompt_ids is not None else [None] * len(results))]
    if len(seqs) != len(results):
        raise ValueError("prompt_ids must have one entry per sequence")
    graph = engine.spec_batch_graph(results, max_new_tokens, draft_len,
                                    history_cap([len(s) for s in seqs], max_new_tokens, draft_len))
    graph.busy = True
    try:
        cols = [engine.make_decode_state(r, 0, pools=(graph.k_pool, graph.v_pool), column=b)[2]
                for b, r in enumerate(results)]
        graph.start(list(zip(*cols)), [r.decode_pos_base for r in results], torch.stack([r.logits for r in results]),
                    seqs, max_new_tokens)
        toks, steps, drafted, accepted = spec_decode_loop_batch(graph, max_new_tokens)
        rows, steps = toks.tolist(), int(steps)
        drafted, accepted = drafted.tolist(), accepted.tolist()
    finally:
        graph.busy = False
    out = [_cut(row, eos_token_id) for row in rows]
    if return_stats:
        return out, {"macro_steps": steps, "drafted": drafted, "accepted": accepted,
                     "tokens_per_pass": (max_new_tokens - 1) / max(steps, 1)}
    return out


def spec_geometry(layer_lens, max_new_tokens: int, draft_len: int, bucket: int) -> tuple[int, int]:
    """The batched speculative pool: (S_pool, write_pos) for sequences whose
    per-layer lengths are ``layer_lens``."""
    region = (draft_len + 1) * max(max_new_tokens - 1, 1) + 1
    s_pool = bucket_length(max(max(seq) for seq in layer_lens) + region, bucket)
    return s_pool, s_pool - region
