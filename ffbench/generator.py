"""The one traffic generator: every mix in ``traffic/<mix>.json`` is data it reads.

A mix gives the sizes of its requests as distributions (frame counts with
their shares, the drift between frames, the answer budget, the questions)
and the arrival process. A cell gives the rate (``cells/<workload>.json``).
The schedule is a pure function of ``--seed``, and every seed serves the
same multiset of requests (frame counts in their shares, each with answer
budgets at stratified quantiles) and the same arrival gaps: seeds change
the order and the pixels, not the amount of work. The requests are either
dealt round-robin into consecutive blocks of ``block`` and shuffled within
each block, or interleaved, each frame count spread evenly over the window
in a pattern the seed rotates, so every stretch of the window carries the
same mix, and runs of different seeds spread little more than runs of one
seed. Arrivals are steady, Poisson, or in bursts: groups of requests at a
multiple of the rate, with quiet between them, at the same times for every
seed.

Pixels: ``coherent_frames`` (a copy of ``chip_smoke.py``'s, whose drift
was fixed at 0.98; here it is drawn per request) on the card in bulk, one
request at a time, then read back as the host's uint8 frames a user sends.
``StubTokenizer`` is a copy of ``chip_smoke.py``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Streams of one seed: each purpose draws from its own child of the seed.
STREAM_SCHEDULE, STREAM_FRAMES, STREAM_WEIGHTS, STREAM_SAMPLE, STREAM_WARM_UP = 1, 2, 3, 4, 5


def child_seed(seed: int, stream: int, n: int = 1) -> list:
    """``n`` 63-bit seeds of ``stream`` under ``seed`` (any whole number >= 0)."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(n, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


class StubTokenizer:
    """Character-level ids below 101: prompts without a tokenizer file.
    (A copy of ``chip_smoke.py``'s ``StubTokenizer``.)"""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 101 for c in text][:40]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    due_s: float  # seconds after the window opens
    n_frames: int
    drift: float
    max_new_tokens: int
    question: str


def _dealt(rng: np.random.Generator, values: np.ndarray, block: int) -> np.ndarray:
    """``values`` (sorted) dealt round-robin into consecutive blocks of
    ``block``, each block shuffled: every block holds an even spread of them."""
    n_blocks = max(1, -(-len(values) // block))
    return np.concatenate([rng.permutation(values[b::n_blocks]) for b in range(n_blocks)])


def _stratified(rng: np.random.Generator, n: int, ppf, block: int) -> np.ndarray:
    """``ppf`` at the n mid-quantiles (i + 0.5) / n, dealt into blocks."""
    return _dealt(rng, ppf((np.arange(n) + 0.5) / n), block)


def _shares(n: int, weights) -> np.ndarray:
    """Counts summing to ``n`` in proportion to ``weights`` (largest remainders)."""
    w = np.asarray(weights, np.float64) / np.sum(weights)
    counts = np.floor(w * n).astype(np.int64)
    order = np.argsort(-(w * n - counts), kind="stable")
    counts[order[: n - counts.sum()]] += 1
    return counts


def _interleaved(n: int, weights) -> np.ndarray:
    """Class indices of n requests in their shares, each class spread as
    evenly as it can be (smooth weighted round-robin)."""
    w = np.asarray(weights, np.float64) / np.sum(weights)
    left = _shares(n, weights)
    credit = np.zeros(len(w))
    out = np.empty(n, np.int64)
    for i in range(n):
        credit += w
        credit[left == 0] = -np.inf
        k = int(np.argmax(credit))
        credit[k] -= 1.0
        left[k] -= 1
        out[i] = k
    return out


def _van_der_corput(k: int) -> np.ndarray:
    """0..k-1 in bit-reversed order: consecutive entries lie far apart."""
    bits = max(1, int(np.ceil(np.log2(max(k, 2)))))
    order = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(2 ** bits)]
    return np.asarray([i for i in order if i < k], np.int64)


def _sizes_interleaved(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 3) rows (frames, budget, drift) in arrival order: the frame
    counts in a fixed evenly spread pattern, rotated by the seed; within
    each frame count the budgets at stratified quantiles in bit-reversed
    order, rotated by the seed; the drifts shuffled."""
    values = mix["frames"]["values"]
    classes = np.roll(_interleaved(n, mix["frames"]["weights"]), int(rng.integers(n)))
    b_lo, b_hi = mix["answer_tokens"]
    d_lo, d_hi = mix["drift"]
    rows = np.empty((n, 3))
    for k, value in enumerate(values):
        idx = np.nonzero(classes == k)[0]
        count = len(idx)
        u = (np.arange(count) + 0.5) / max(count, 1)
        budgets = np.floor(b_lo + (b_hi - b_lo + 1) * u)[_van_der_corput(count)]
        rows[idx, 0] = value
        rows[idx, 1] = np.roll(budgets, int(rng.integers(max(count, 1))))
        rows[idx, 2] = d_lo + (d_hi - d_lo) * rng.permutation(u)
    return rows


def _sizes(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 3) rows (frames, answer budget, drift), sorted by frames then
    budget: the frame counts in their shares, and within each frame count
    the budgets (and, in an order drawn by ``rng``, the drifts) at
    stratified quantiles, so every seed serves the same (frames, budget)
    pairs."""
    b_lo, b_hi = mix["answer_tokens"]
    d_lo, d_hi = mix["drift"]
    rows = []
    for value, count in zip(mix["frames"]["values"], _shares(n, mix["frames"]["weights"])):
        u = (np.arange(count) + 0.5) / max(count, 1)
        budgets = np.floor(b_lo + (b_hi - b_lo + 1) * u)
        drift = d_lo + (d_hi - d_lo) * rng.permutation(u)
        rows.append(np.stack([np.full(count, value, np.float64), budgets, drift], axis=1))
    return np.concatenate(rows)


def schedule(mix: dict, rate_rps: float, seconds: float, seed: int) -> list:
    """The requests due in a window of ``seconds``: ``mix["backlog"]`` (if
    any) due at its opening, then ``round(rate_rps * seconds)`` more, spread
    over the window by ``mix["arrival"]``: ``"uniform"``, one every 1 / rate;
    ``"poisson"``, open-loop Poisson gaps (stratified exponential quantiles
    dealt into the blocks); or ``"bursts"``, groups of
    ``mix["burst"]["requests"]`` one every requests / rate seconds, each
    group's requests due evenly at ``mix["burst"]["peak"]`` times the rate.
    ``mix["order"]``: ``"blocks"`` deals the sizes into blocks of
    ``mix["block"]`` in the order of arrival; ``"interleaved"`` spreads each
    frame count evenly over the window."""
    rng = np.random.default_rng(child_seed(seed, STREAM_SCHEDULE)[0])
    n_stream = max(1, int(round(rate_rps * seconds)))
    backlog = int(mix.get("backlog", 0))
    n = backlog + n_stream
    block = int(mix.get("block", n))
    if mix["order"] == "interleaved":
        sizes = _sizes_interleaved(mix, n, rng)
    elif mix["order"] == "blocks":
        sizes = _sizes(mix, n, rng)[_dealt(rng, np.arange(n), block)]
    else:
        raise ValueError(f"unknown order {mix['order']!r} (interleaved|blocks)")
    questions = mix["questions"]
    q_idx = rng.permutation(np.arange(n) % len(questions))
    if mix["arrival"] == "uniform":
        due = (np.arange(n_stream) + 0.5) * seconds / n_stream
    elif mix["arrival"] == "poisson":
        gaps = _stratified(rng, n_stream, lambda u: -np.log1p(-u) / rate_rps, block)
        due = np.cumsum(gaps)
        due = due * (seconds * n_stream / (n_stream + 1)) / due[-1]
    elif mix["arrival"] == "bursts":
        k, peak = int(mix["burst"]["requests"]), float(mix["burst"]["peak"])
        if k < 1 or peak < 1:
            raise ValueError(f"a burst needs requests >= 1 and peak >= 1, got {mix['burst']}")
        i = np.arange(n_stream)
        due = (i // k) * k / rate_rps + (i % k + 0.5) / (peak * rate_rps)
    else:
        raise ValueError(f"unknown arrival {mix['arrival']!r} (uniform|poisson|bursts)")
    due = np.concatenate([np.zeros(backlog), due])
    return [Request(index=i, due_s=float(due[i]), n_frames=int(sizes[i, 0]), drift=float(sizes[i, 2]),
                    max_new_tokens=int(sizes[i, 1]), question=questions[int(q_idx[i])]) for i in range(n)]


def coherent_frames(gen, n: int, h: int, w: int, drift: float, device) -> np.ndarray:
    """uint8 (n, h, w, 3) video: each frame drifts from the last by
    ``drift`` (``chip_smoke.coherent_frames`` with the drift a parameter and
    the draws on ``device`` from the torch generator ``gen``)."""
    import torch

    fr = torch.randn((n, h, w, 3), generator=gen, device=device, dtype=torch.float32)
    for f in range(1, n):
        fr[f].mul_(0.2).add_(fr[f - 1], alpha=drift)
    return fr.mul_(40).add_(128).clamp_(0, 255).to(torch.uint8).cpu().numpy()


def draw_frames(requests: list, seed: int, shape, device, stream: int = STREAM_FRAMES) -> dict:
    """{request index: uint8 frames}: each request's video from its own seed."""
    import torch

    seeds = child_seed(seed, stream, len(requests))
    out = {}
    for req, s in zip(requests, seeds):
        gen = torch.Generator(device=device).manual_seed(s)
        out[req.index] = coherent_frames(gen, req.n_frames, shape[0], shape[1], req.drift, device)
    return out


def check_sample(requests: list, k: int, seed: int) -> list:
    """Indices of the requests the output check reads: the longest (most
    frames, then the largest budget), and ``k - 1`` more drawn from the seed."""
    longest = max(requests, key=lambda r: (r.n_frames, r.max_new_tokens, -r.index)).index
    rest = [r.index for r in requests if r.index != longest]
    rng = np.random.default_rng(child_seed(seed, STREAM_SAMPLE)[0])
    extra = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) if k > 1 and rest else []
    return sorted([longest, *map(int, extra)])


def expected_requests(rate_rps: float, seconds: float, backlog: int = 0) -> int:
    return backlog + max(1, int(round(rate_rps * seconds)))

