"""Shared helpers of the port's example scripts.

Every script runs in one of two modes:
  * ``--checkpoint DIR``: real safetensors weights (``weights.load_checkpoint``)
    and, with ``--video`` and a decoder (PIL for a directory of frames,
    decord or av for a file), real frames;
  * default: random weights at the family's geometry, drawn from a seed, and
    a synthetic temporally coherent video. The A/B timings and the
    compression telemetry are real either way.

Scripts run on the card (``--device cuda``, the default) or, when asked,
on the CPU (``--device cpu``, plain versions of the kernels); without a card
and without that flag they exit with an error rather than fall back.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..runtime import profiling


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the card (default) or, when asked, on the CPU")


def resolve_device(name: str) -> torch.device:
    """The device a script runs on: the card unless ``--device cpu``. With no
    card and no such flag it exits non-zero: a script never falls back to
    the CPU on its own."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs on the card; pass --device cpu to run it on the CPU")
    return torch.device("cuda")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded torch generator on ``device`` (random weights are drawn there)."""
    return torch.Generator(device=device).manual_seed(seed)


def load_video_frames(path: str, num_frames: int, size: int):
    """Uniformly sample ``num_frames`` frames: from a directory of image
    files (sorted by name, read with PIL, needs no video decoder), else with
    decord, else with av. Each is resized to (size, size) and scaled to
    [-1, 1]; returns a float32 (num_frames, size, size, 3) array."""
    if os.path.isdir(path):
        import PIL.Image as Image

        names = sorted(
            n for n in os.listdir(path)
            if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp"))
        )
        if not names:
            raise FileNotFoundError(f"no image files in frame directory {path}")
        idx = np.linspace(0, len(names) - 1, num_frames).astype(int)
        frames = np.stack([
            np.asarray(Image.open(os.path.join(path, names[i])).convert("RGB"))
            for i in idx
        ])
    else:
        try:
            import decord

            vr = decord.VideoReader(path)
            idx = np.linspace(0, len(vr) - 1, num_frames).astype(int)
            frames = vr.get_batch(idx).asnumpy()
        except Exception:
            import av  # may be absent too: the caller sees the ImportError

            container = av.open(path)
            all_frames = [f.to_ndarray(format="rgb24") for f in container.decode(video=0)]
            idx = np.linspace(0, len(all_frames) - 1, num_frames).astype(int)
            frames = np.stack([all_frames[i] for i in idx])
    import PIL.Image as Image

    out = []
    for f in frames:
        im = Image.fromarray(f).resize((size, size))
        out.append(np.asarray(im, np.float32) / 127.5 - 1.0)
    return np.stack(out)


def synthetic_video(rng, num_frames: int, size: int, scene_len: int = 16):
    """Temporally coherent random video: slow drift within scenes, cuts between."""
    frames = np.empty((num_frames, size, size, 3), np.float32)
    cur = rng.standard_normal((size, size, 3)).astype(np.float32)
    for i in range(num_frames):
        if i % scene_len == 0 and i:
            cur = rng.standard_normal((size, size, 3)).astype(np.float32)
        cur = cur + 0.08 * rng.standard_normal((size, size, 3)).astype(np.float32)
        frames[i] = np.clip(cur, -1, 1)
    return frames


def tiny_config(device: torch.device, **kw):
    """``tiny_llm_config(**kw)``, the JAX scripts' small geometry. On the
    card its heads widen to 128 (hidden, intermediate and any mRoPE
    sections scaled alike) in bf16: kernel A takes head dim 128 only."""
    from ..config import tiny_llm_config

    cfg = tiny_llm_config(**kw)
    if device.type != "cuda" or cfg.head_dim_ == 128:
        return cfg
    f = 128 // cfg.head_dim_
    mrope = tuple(m * f for m in cfg.mrope_section) if cfg.mrope_section else None
    return cfg.replace(hidden_size=cfg.hidden_size * f, intermediate_size=cfg.intermediate_size * f,
                       mrope_section=mrope, dtype=torch.bfloat16)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (its name
    alone without nvidia-smi), or "CPU"."""
    if device.type != "cuda":
        return "CPU"
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def timing_note(device: torch.device, reps: int = 3) -> str:
    clock = "CUDA events" if device.type == "cuda" else "the host clock"
    return f"(ms from {clock} on {device_label(device)}, median of {reps} runs after a warm-up)"


class DeviceTimer:
    """Timing that waits for the device's work, run by run, through the
    port's timer ``runtime.profiling.elapsed`` (CUDA events on the card, the
    host clock on the CPU)."""

    @staticmethod
    def once(fn, on_card: bool):
        """(seconds, fn()) of one run (``runtime.profiling.elapsed``)."""
        return profiling.elapsed(fn, on_card)

    @staticmethod
    def timeit(fn, probe, reps=3):
        """Median seconds of ``reps`` runs after one warm-up run, and the
        last run's output. ``probe(out)`` picks a tensor of the output; its
        device says how to time (CUDA events on the card)."""
        out = fn()
        on_card = probe(out).device.type == "cuda"
        times = []
        for _ in range(reps):
            t, out = DeviceTimer.once(fn, on_card)
            times.append(t)
        times.sort()
        return times[len(times) // 2], out

    @staticmethod
    def timeit_slope(run, probe, rounds=3):
        """``timeit`` of ``run()``, ``rounds`` samples. The name is kept for
        the scripts that call it; the slope over chained runs that it stands
        for cancelled a remote runner's read latency, which a card attached
        to its host does not have, so the same events time it."""
        return DeviceTimer.timeit(run, probe, reps=rounds)


def ab_table(rows) -> str:
    """Rows of dicts as a right-aligned text table, one column a key (in
    first-seen order), no index column."""
    cols: list = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    cells = [[str(c) for c in cols]] + [[str(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(line[i]) for line in cells) for i in range(len(cols))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(line, widths)) for line in cells)


def ab_prefill(model, ff_model, inputs, max_new_tokens: int = 0, reps: int = 3) -> dict:
    """The A/B of the example scripts on built models: the dense and the
    FrameFusion prefill of ``inputs`` timed (``DeviceTimer.timeit``), then
    ``max_new_tokens`` greedy tokens from each (none for 0)."""
    dense_t, dense_res = DeviceTimer.timeit(lambda: model.prefill(inputs), lambda r: r.logits, reps)
    ff_t, ff_res = DeviceTimer.timeit(lambda: ff_model.prefill(inputs), lambda r: r.logits, reps)
    out = {"dense_s": dense_t, "ff_s": ff_t, "dense": dense_res, "ff": ff_res}
    if max_new_tokens:
        out["dense_tokens"] = model.engine().generate_greedy(dense_res, max_new_tokens)
        out["ff_tokens"] = ff_model.engine().generate_greedy(ff_res, max_new_tokens)
    return out


def ab_rows(ab: dict) -> list:
    """The A/B table's rows (method, prefill_ms, tokens_kept[, first_tokens])."""
    rows = []
    for method, key in (("dense", "dense"), ("framefusion", "ff")):
        row = {"method": method, "prefill_ms": round(ab[f"{key}_s"] * 1e3, 1), "tokens_kept": ab[key].valid_len}
        if f"{key}_tokens" in ab:
            row["first_tokens"] = ab[f"{key}_tokens"][:8]
        rows.append(row)
    return rows


def print_ab(ab: dict, device: torch.device, reps: int = 3) -> None:
    """The family examples' closing lines: the table, the clock, the
    speedup and the vision-token reduction."""
    print(ab_table(ab_rows(ab)))
    print(timing_note(device, reps))
    print(f"\nspeedup: {ab['dense_s'] / ab['ff_s']:.2f}x | reduction: "
          f"{ab['ff'].telemetry.vision_token_reduction:.1%}")
