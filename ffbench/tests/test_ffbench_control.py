"""``correct`` comes out false for the control and for each fault the cells can have.

The control is the reference a precision down (pixels in bf16, the tower's
matrices in fp8, the decoder's in int4) put in the program's place; each
fault breaks the timed path underneath a whole run. At these tiny fp32
sizes the sound program reads 0 on every number, so the tiny limits below
sit at rounding; the cells' own limits (``cells/``) were set on the card."""

import dataclasses
import json

import pytest

from ffbench import check, run
from ffbench.tests import tiny

SEED = 2**31 + 4242
TINY_LIMITS = {"pixel_err": 1e-5, "feature_err": 1e-5, "logit_gap": 1e-4}


def test_control_fails_the_cells_limits(tiny_bench):
    result, checks = run.run_cell(tiny_bench, "llava7b.qa", SEED, 2.0, False, device="cpu", control=True)
    assert result["correct"]
    control = check.control_values({k: c["value"] for k, c in checks.items()})
    assert set(control) == {*check.NAMES, "events_differ"}
    for cell in ("llava7b.qa", "llava7b.qa_bursts", "internvl8b.qa", "llava7b.captions"):
        limits = json.loads((tiny.REPO / "ffbench" / "cells" / f"{cell}.json").read_text())["limits"]
        correct, _ = check.judge(control, limits, 0, 0)
        assert not correct


def _state_unchanged(program, loop):
    """The decode step computes, then its writes to the cache are undone."""
    macro = loop._macro_step

    def step(split, commit=True):
        pools = [p for p in (loop.k_pool, loop.v_pool, loop.k_tail, loop.v_tail) if p is not None]
        saved = [p.clone() for p in pools]
        macro(split, commit)
        for p, s in zip(pools, saved):
            p.copy_(s)

    loop._macro_step = step


def _half_the_slots(program, loop):
    """Every other slot (the first among them, which an idle loop fills
    first) is left out of every decode step: its answers stop at the
    prefill's token."""
    macro = loop._macro_step

    def step(split, commit=True):
        loop.active_d[0::2] = False
        macro(split, commit)

    loop._macro_step = step


def _token_altered(program, loop):
    """Each answer's second token is altered where the step writes it."""
    macro = loop._macro_step

    def step(split, commit=True):
        macro(split, commit)
        loop.out[:, 1] = (loop.out[:, 1] + 7) % loop.cfg.vocab_size

    loop._macro_step = step


def _other_compression(program, loop):
    """The engine's merges and prunes run at another FLOP budget than the
    configuration states: other keep sets, other events."""
    loop.engine.ff = dataclasses.replace(loop.engine.ff, cost=0.6)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_slots, _token_altered, _other_compression])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    bench = tiny.make_bench(tmp_path, limits=TINY_LIMITS)
    sound, _ = run.run_cell(bench, "llava7b.qa", SEED, 2.0, False, device="cpu")
    assert sound["correct"]
    broken, checks = run.run_cell(bench, "llava7b.qa", SEED, 2.0, False, device="cpu", fault=fault,
                                  drain_limit_s=2.0)
    assert not broken["correct"], checks


def test_other_compression_events_are_counted(tmp_path):
    """With the reference's limits on the other numbers opened wide, the
    events alone make the run not correct."""
    bench = tiny.make_bench(tmp_path, limits={"pixel_err": 1e-5, "feature_err": 1e-5, "logit_gap": 1e9})
    broken, checks = run.run_cell(bench, "llava7b.qa", SEED, 2.0, False, device="cpu", fault=_other_compression)
    assert checks["events_differ"]["value"] > 0 and checks["events_differ"]["limit"] == 0
    assert not broken["correct"]
