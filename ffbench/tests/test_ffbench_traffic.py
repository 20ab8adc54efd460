"""The traffic is a pure function of ``--seed``, and every seed serves the same work."""

import collections
import json

import numpy as np
import pytest
import torch

from ffbench import generator
from ffbench.tests.tiny import REPO

MIXES = {name: json.loads((REPO / "ffbench" / "traffic" / f"{name}.json").read_text())
         for name in ("qa", "qa_bursts", "captions")}
CASES = [("qa", 1.12, 51.0), ("qa_bursts", 1.12, 51.0), ("captions", 0.96, 51.0), ("qa", 2.0, 7.0),
         ("qa_bursts", 2.0, 7.0)]
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("mix,rate,seconds", CASES)
def test_schedule_is_a_pure_function_of_the_seed(mix, rate, seconds):
    a = generator.schedule(MIXES[mix], rate, seconds, BIG_SEED)
    assert a == generator.schedule(MIXES[mix], rate, seconds, BIG_SEED)
    assert a != generator.schedule(MIXES[mix], rate, seconds, BIG_SEED + 1)


@pytest.mark.parametrize("mix,rate,seconds", CASES)
def test_every_seed_serves_the_same_work(mix, rate, seconds):
    runs = [generator.schedule(MIXES[mix], rate, seconds, s) for s in (1, 2, 2**40 + 3)]
    for reqs in runs:
        assert len(reqs) == generator.expected_requests(rate, seconds, MIXES[mix].get("backlog", 0))
        assert all(0 <= r.due_s < seconds for r in reqs)
        assert [r.due_s for r in reqs] == sorted(r.due_s for r in reqs)
        lo, hi = MIXES[mix]["answer_tokens"]
        assert all(lo <= r.max_new_tokens <= hi and r.n_frames in MIXES[mix]["frames"]["values"] for r in reqs)
    pairs = [sorted((r.n_frames, r.max_new_tokens) for r in reqs) for reqs in runs]
    gaps = [sorted(np.round(np.diff([0.0] + [r.due_s for r in reqs]), 9)) for reqs in runs]
    assert pairs[0] == pairs[1] == pairs[2]
    assert gaps[0] == gaps[1] == gaps[2]


@pytest.mark.parametrize("mix", ["qa", "qa_bursts"])
def test_each_block_carries_the_mix(mix):
    """Every stretch of 16 requests holds the frame counts in their shares."""
    mix = MIXES[mix]
    reqs = generator.schedule(mix, 1.12, 51.0, 7)
    n_blocks = -(-len(reqs) // 16)
    size = len(reqs) / n_blocks
    shares = dict(zip(mix["frames"]["values"], mix["frames"]["weights"]))
    start = 0
    for b in range(n_blocks):
        members = reqs[b::n_blocks]
        block = reqs[start:start + len(members)]
        start += len(members)
        counts = collections.Counter(r.n_frames for r in block)
        for value, share in shares.items():
            assert abs(counts[value] - share * size) <= 1.5


@pytest.mark.parametrize("seed", [3, BIG_SEED])
def test_bursts_come_at_the_peak_rate_then_quiet(seed):
    mix = MIXES["qa_bursts"]
    k, peak, rate = mix["burst"]["requests"], mix["burst"]["peak"], 1.12
    due = np.array([r.due_s for r in generator.schedule(mix, rate, 51.0, seed)])
    gaps = np.diff(due)
    within = np.arange(1, len(due)) % k != 0
    np.testing.assert_allclose(gaps[within], 1.0 / (peak * rate))
    np.testing.assert_allclose(gaps[~within], 1.0 / (peak * rate) + (k - k / peak) / rate)
    np.testing.assert_allclose(due[::k], np.arange(len(due[::k])) * k / rate + 0.5 / (peak * rate))


def test_frames_are_a_pure_function_of_the_seed():
    reqs = generator.schedule(MIXES["qa"], 2.0, 2.0, BIG_SEED)
    a = generator.draw_frames(reqs, BIG_SEED, (12, 16), "cpu")
    b = generator.draw_frames(reqs, BIG_SEED, (12, 16), "cpu")
    c = generator.draw_frames(reqs, BIG_SEED + 1, (12, 16), "cpu")
    for r in reqs:
        assert a[r.index].dtype == np.uint8 and a[r.index].shape == (r.n_frames, 12, 16, 3)
        np.testing.assert_array_equal(a[r.index], b[r.index])
    assert any(not np.array_equal(a[r.index], c[r.index]) for r in reqs)


def test_frames_drift_from_the_last():
    gen = torch.Generator().manual_seed(0)
    frames = generator.coherent_frames(gen, 8, 32, 32, 0.99, "cpu").astype(np.float64)
    near = np.corrcoef(frames[3].ravel(), frames[4].ravel())[0, 1]
    assert near > 0.9


def test_check_sample_holds_the_longest():
    reqs = generator.schedule(MIXES["qa"], 1.12, 51.0, 11)
    sample = generator.check_sample(reqs, 8, 11)
    longest = max(reqs, key=lambda r: (r.n_frames, r.max_new_tokens))
    assert len(sample) == 8 and len(set(sample)) == 8
    assert longest.n_frames in {reqs[i].n_frames for i in sample}
    assert max(reqs[i].max_new_tokens for i in sample if reqs[i].n_frames == longest.n_frames) == \
        longest.max_new_tokens
    assert sample == generator.check_sample(reqs, 8, 11)
