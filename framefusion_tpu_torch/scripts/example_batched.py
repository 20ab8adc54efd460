"""Batched serving example: B video prompts, their compressed prefills, then
ONE batched decode of them all, on one H100.

A prefill is compute-bound, so requests prefill one after another (or, with
``--batched-prefill``, as one lockstep batch); a decode step streams every
decoder weight, so one batched step serves B sequences for little more than
one's cost (kernels C and D at B rows). The reference serves one sequence
at a time.

Usage:
    python -m framefusion_tpu_torch.scripts.example_batched [--batch 4] [--new-tokens 32] [--frames 16]
        [--int8] [--batched-prefill] [--speculative] [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from .common import DeviceTimer, add_device_arg, device_label, generator, resolve_device, tiny_config


def build_prompts(hidden: int, batch: int, frames: int, patch_num: int) -> list:
    """``batch`` distinct prompts from one numpy stream (seed 0), coherence
    cycling 0.35 / 0.45 / 0.55: (embeds, patch_type, positions, start, length)."""
    from ..models.adapters.common import build_video_prompt

    rng = np.random.default_rng(0)
    prompts = []
    for b in range(batch):
        h, pt, img_start, n_img = build_video_prompt(rng, hidden, n_frames=frames, patch_num=patch_num,
                                                     coherent=0.35 + 0.1 * (b % 3))
        prompts.append((h, pt, np.arange(len(pt), dtype=np.int32), img_start, n_img))
    return prompts


def run_batched(engine, prompts, patch_num: int, new_tokens: int, batched_prefill: bool = False,
                speculative: bool = False) -> dict:
    """The example on a built engine: the prefills (sequential, or one
    lockstep batch), ``generate_batch`` against ``generate_greedy`` of the
    first prompt, and with ``speculative`` the oracle-seeded
    ``generate_spec_batch``; each timed after a warm-up call. Returns the
    results, the token lists, the seconds and the speculative stats."""
    on_card = engine.device.type == "cuda"
    out = {}

    def prefill(p):
        h, pt, pos, img_start, n_img = p
        return engine.prefill(h, pt, pos, patch_num=patch_num, image_token_start=img_start,
                              image_token_length=n_img)

    if batched_prefill:
        engine.prefill_planned_batch(prompts, patch_num=patch_num)  # warm-up
        out["prefill_s"], results = DeviceTimer.once(lambda: engine.prefill_planned_batch(prompts, patch_num),
                                                     on_card)
        print(f"{len(prompts)} compressed prefills (ONE lockstep-batched program): {out['prefill_s']*1e3:.0f} ms "
              f"({[r.valid_len for r in results]} tokens kept, modes={sorted({r.mode for r in results})})")
    else:
        prefill(prompts[0])  # warm-up
        out["prefill_s"], results = DeviceTimer.once(lambda: [prefill(p) for p in prompts], on_card)
        print(f"{len(prompts)} compressed prefills (sequential): {out['prefill_s']*1e3:.0f} ms "
              f"({[r.valid_len for r in results]} tokens kept)")
    out["results"] = results

    engine.generate_batch(results, max_new_tokens=new_tokens)  # warm-up: the graph's capture
    out["batch_s"], toks_b = DeviceTimer.once(lambda: engine.generate_batch(results, max_new_tokens=new_tokens),
                                              on_card)
    engine.generate_greedy(results[0], max_new_tokens=new_tokens)
    out["single_s"], toks_1 = DeviceTimer.once(lambda: engine.generate_greedy(results[0], new_tokens), on_card)
    out["tokens_batch"], out["tokens_single"] = toks_b, toks_1

    # Both start from the argmax of the same prefill logits; later tokens
    # may part at bf16 near-ties (the batched step sums in another order).
    assert toks_b[0][0] == toks_1[0], "first decoded token must match"
    agree = sum(a == b for a, b in zip(toks_b[0], toks_1))
    b, n = len(prompts), new_tokens
    t_single, t_batch = out["single_s"], out["batch_s"]
    print(f"batched[0] vs single agreement: {agree}/{len(toks_1)} tokens")
    print(f"decode {n} tokens  B=1: {t_single*1e3:7.1f} ms  ({n/t_single:7.1f} tok/s)")
    print(f"decode {n} tokens  B={b}: {t_batch*1e3:7.1f} ms  ({b*n/t_batch:7.1f} tok/s total, "
          f"{t_batch/t_single:.2f}x wall for {b}x tokens)")

    if speculative:
        # Oracle-seeded: each sequence's drafts come from its own greedy
        # output, so nearly every draft is accepted (the draft-and-verify
        # pass's ceiling); the tokens are the batched greedy decode's.
        hints = [np.asarray(t, np.int32) for t in toks_b]
        engine.generate_spec_batch(results, new_tokens, prompt_ids=hints)
        out["spec_s"], (toks_s, stats) = DeviceTimer.once(
            lambda: engine.generate_spec_batch(results, new_tokens, prompt_ids=hints, return_stats=True), on_card)
        for bs, bb in zip(toks_s, toks_b):
            assert bs[0] == bb[0], "speculative first token must match greedy"
        agree_s = sum(x == y for t_s, t_b in zip(toks_s, toks_b) for x, y in zip(t_s, t_b))
        total_s = sum(len(t) for t in toks_b)
        out["tokens_spec"], out["spec_stats"] = toks_s, stats
        print(f"decode {n} tokens  B={b} speculative(oracle): {out['spec_s']*1e3:7.1f} ms  "
              f"({b*n/out['spec_s']:7.1f} tok/s, {stats['tokens_per_pass']:.2f} tok/weight-pass, "
              f"{stats['macro_steps']} passes; greedy agreement {agree_s}/{total_s})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--tiny", action="store_true", help="tiny config (the CPU's)")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 (halves the decode's weight stream)")
    ap.add_argument("--batched-prefill", action="store_true",
                    help="run the B prefills as ONE lockstep batch (engine.prefill_planned_batch)")
    ap.add_argument("--speculative", action="store_true",
                    help="also time the oracle-seeded speculative batched decode (engine.generate_spec_batch)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..config import FrameFusionConfig, qwen2_7b_config
    from ..models import qwen2
    from ..runtime.engine import CompressionEngine

    if args.tiny or device.type == "cpu":
        cfg = tiny_config(device, num_layers=4)
        patch_num, frames = 6, 8
    else:
        cfg = qwen2_7b_config(vocab_size=8192)
        patch_num, frames = 182, args.frames
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    params = qwen2.init_params(cfg, generator(device, 0))
    if args.int8:
        from ..ops.quant import quantize_params_int8

        params = quantize_params_int8(params)
    engine = CompressionEngine(params, cfg, ff, attn_impl="flash" if device.type == "cuda" else "einsum")
    prompts = build_prompts(cfg.hidden_size, args.batch, frames, patch_num)
    out = run_batched(engine, prompts, patch_num, args.new_tokens, args.batched_prefill, args.speculative)
    clock = "CUDA events" if device.type == "cuda" else "the host clock"
    print(f"(ms from {clock} on {device_label(device)}, one timed run after a warm-up)")
    return out


if __name__ == "__main__":
    main()
