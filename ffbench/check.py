"""Whether what the timed path produced is correct: the plain reference over a seeded sample.

Once the window has closed and the program's state is freed, the plain
reference (``reference/``) works each sampled request out again from its
raw frames and the run's seeded weights, and three numbers are compared:

* ``pixel_err``: the largest absolute difference between the program's
  preprocessed pixels and the reference's;
* ``feature_err``: the largest, over the sample, of the relative Frobenius
  error of the program's video tokens (the tower and projector's output as
  the prompt holds it);
* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best, over every served token of the sample: the first
  from the compressed prefill's logits, the rest decoded through the serving
  loop's cache. The reference makes its own compression decisions, so a
  wrong merge or prune shows here too.

Besides, every request due in the window has to be answered, each answer
with its whole budget (no end token is set), and ``events_differ``, the
number of sampled requests whose compression events (layer, kind, tokens
removed) differ from the reference's, has the limit 0.
``readings(..., control=True)`` gives the same numbers for the control: the
reference in the next precision down.

The decoder of both is the kind's (``reference.decoder``): the one that
``reference/<kind>.py`` defines, or the dense stacks of
``weights.decoder_tensors`` in ``common.Decoder`` for a kind that defines
none. ``forward`` takes the whole sample layer-major, so a decoder that
draws and frees its layers as the pass reaches them draws each once; the
control's decoder is made after the reference's is freed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from . import reference
from .reference import common

NAMES = ("pixel_err", "feature_err", "logit_gap")


@dataclasses.dataclass
class Sample:
    request: object  # generator.Request
    frames: np.ndarray  # the raw uint8 video
    pixels: np.ndarray  # the program's preprocessed pixels
    features: object  # the program's video tokens, (n, D) on the card
    tokens: list  # the served answer
    events: Optional[list] = None  # the program's compression events


def _rel(a, b) -> float:
    return float((a.float() - b).norm() / b.norm())


def readings(config: dict, seed: int, samples: list, device, control: bool = False) -> dict:
    """{name: largest reading over the samples} for the reference; with
    ``control``, also {"control." + name: ...} for the control, which is
    judged by the reference: its pixels and tokens against the reference's,
    and the reference's logit of the token it puts first at each position."""
    import torch

    ref = reference.load(config["kind"])
    size = config["vision"]["image_size"]
    out = {name: 0.0 for name in NAMES}
    if control:
        out.update({"control." + name: 0.0 for name in NAMES})
    events_differ = control_events_differ = 0
    with common.precise(), torch.no_grad():
        tower, proj = ref.tower_weights(config, seed, device)
        feats = []
        for s in samples:
            px = common.preprocess(s.frames, size, ref.MEAN, ref.STD, common.REFERENCE)
            out["pixel_err"] = max(out["pixel_err"], float(np.abs(s.pixels - px).max()))
            f = ref.features(config, tower, proj, px, common.REFERENCE, device)
            out["feature_err"] = max(out["feature_err"], _rel(s.features.to(device), f.reshape(-1, f.shape[-1])))
            fc = None
            if control:
                pxc = common.preprocess(s.frames, size, ref.MEAN, ref.STD, common.CONTROL)
                out["control.pixel_err"] = max(out["control.pixel_err"], float(np.abs(pxc - px).max()))
                fc = ref.features(config, tower, proj, pxc, common.CONTROL, device)
                out["control.feature_err"] = max(out["control.feature_err"],
                                                 _rel(fc.reshape(-1, fc.shape[-1]), f.reshape(-1, f.shape[-1])))
            feats.append((f, fc))
        del tower, proj
        ff, served = config["framefusion"], [s.tokens for s in samples]
        dec = reference.decoder(config, seed, device, common.REFERENCE)
        prompts = [ref.prompt(config, s.request.question, f, dec.embed) for s, (f, _) in zip(samples, feats)]
        if control:
            prompts_c = [ref.prompt(config, s.request.question, fc, dec.embed) for s, (_, fc) in zip(samples, feats)]
        del feats
        passed = dec.forward(prompts, served, ff)
        del dec, prompts
        for s, (logits, events) in zip(samples, passed):
            out["logit_gap"] = max(out["logit_gap"], common.served_gap(logits, s.tokens))
            if s.events is not None and [tuple(e) for e in s.events] != [tuple(e) for e in events]:
                events_differ += 1
        if control:
            ctl = reference.decoder(config, seed, device, common.CONTROL)
            for (logits, events), (logits_c, events_c) in zip(passed, ctl.forward(prompts_c, served, ff)):
                control_events_differ += [tuple(e) for e in events_c] != [tuple(e) for e in events]
                picks = torch.argmax(logits_c, dim=1)
                out["control.logit_gap"] = max(out["control.logit_gap"], common.served_gap(logits, picks))
    out["events_differ"] = events_differ
    if control:
        out["control.events_differ"] = control_events_differ
    return out


def control_values(values: dict) -> dict:
    """The control's readings under the names ``judge`` compares."""
    return {k[len("control."):]: v for k, v in values.items() if k.startswith("control.")}


def judge(values: dict, limits: dict, unfinished: int, short: int) -> tuple:
    """(correct, checks): each compared number beside its limit."""
    checks = {"unfinished": {"value": unfinished, "limit": 0}, "short_answers": {"value": short, "limit": 0},
              "events_differ": {"value": values.get("events_differ"), "limit": 0}}
    for name in NAMES:
        v = values.get(name)
        checks[name] = {"value": v if v is not None and math.isfinite(v) else None, "limit": limits.get(name)}
    correct = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
