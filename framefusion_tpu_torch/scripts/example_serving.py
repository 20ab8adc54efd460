"""Continuous-batching serving example: a stream of video-QA requests served
through a fixed set of slots (``runtime/serving.py``) on one H100.

Requests queue in arrival order; each is admitted into a freed slot through
its own compressed prefill, then decodes in lockstep with whatever else is
in flight, one captured chunk of decode steps a scheduling quantum. The
reference serves one request at a time.

Usage:
    python -m framefusion_tpu_torch.scripts.example_serving [--requests 8] [--slots 4] [--chunk 8]
        [--new-tokens 32] [--frames 16] [--speculative] [--int8] [--tiny] [--tail-pool]
        [--arrival-rate R] [--sequential-baseline] [--slots-sweep 1,2,4] [--json PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from .common import add_device_arg, device_label, generator, resolve_device, tiny_config


def percentiles(vals, ps=(50, 95)):
    """{"p50": ms, ...} of second values (nearest rank)."""
    vals = sorted(vals)
    out = {}
    for p in ps:
        k = min(int(round(p / 100 * (len(vals) - 1))), len(vals) - 1)
        out[f"p{p}"] = round(vals[k] * 1e3, 1)
    return out


def run_loop(engine, reqs, arrival_offsets, *, slots, chunk, max_new, prefix_cap, draft=0, prefill_mode="fused",
             tail_pool=None):
    """Serve ``reqs``, request i submitted ``arrival_offsets[i]`` seconds
    after the start (0: all queued at once). The loop steps through idle
    gaps, so late requests join when their time comes and ``queue_s`` is
    the scheduling wait. Returns (results by request index, wall seconds,
    the loop)."""
    from ..runtime.serving import ServingLoop

    loop = ServingLoop(engine, max_slots=slots, max_new_cap=max_new, chunk_steps=chunk, draft_len=draft,
                       prefix_cap=prefix_cap, prefill_mode=prefill_mode, tail_pool=tail_pool)
    pending = sorted(range(len(reqs)), key=lambda i: arrival_offsets[i])
    rid_of = {}
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while pending and arrival_offsets[pending[0]] <= now:
            i = pending.pop(0)
            rid_of[i] = loop.submit(reqs[i])
        if not loop.step():
            if not pending:
                break
            wait = arrival_offsets[pending[0]] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, 0.02))
    dt = time.perf_counter() - t0
    results = loop.run()  # drains nothing when the loop has drained
    return {i: results[rid_of[i]] for i in rid_of}, dt, loop


def build_requests(engine, n: int, frames: int, patch_num: int, new_tokens: int, fixed_budget: bool) -> list:
    """``n`` requests from one numpy stream (seed 0): prompts of coherence
    0.35 / 0.45 / 0.55 in turn, budgets uniform in [new_tokens / 2,
    new_tokens] unless ``fixed_budget``."""
    from ..models.adapters.common import PrefillInputs, build_video_prompt
    from ..runtime.serving import ServeRequest

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        h, pt, img_start, n_img = build_video_prompt(rng, engine.cfg.hidden_size, n_frames=frames,
                                                     patch_num=patch_num, coherent=0.35 + 0.1 * (i % 3))
        inp = PrefillInputs(input_embeds=h, patch_type=pt, position_ids=np.arange(len(pt), dtype=np.int32),
                            patch_num=patch_num, image_token_start=img_start, image_token_length=n_img)
        budget = new_tokens if fixed_budget else int(rng.integers(new_tokens // 2, new_tokens + 1))
        reqs.append(ServeRequest(inp, max_new_tokens=budget))
    return reqs


def serve(engine, reqs, args, prefix_cap: int, frames: int) -> tuple:
    """The example on a built engine and requests: the serving loop at each
    slot count (``--slots``, ``--slots-sweep``, 1 for
    ``--sequential-baseline``), the oracle-seeded speculative pass with
    ``--speculative``, and request 0 against its solo greedy decode.
    Returns (the JSON record, results by request index)."""
    from ..runtime.serving import ServeRequest, ServingLoop

    prefix_cap = max(prefix_cap, len(reqs[0].inputs.patch_type) + engine.ff.bucket)
    # Poisson arrivals at --arrival-rate (exponential gaps), shared by every
    # loop measured, so the sweep compares the same workload.
    arr_rng = np.random.default_rng(7)
    if args.arrival_rate > 0:
        arrivals = np.cumsum(arr_rng.exponential(1.0 / args.arrival_rate, size=len(reqs)))
        arrivals[0] = 0.0
    else:
        arrivals = np.zeros(len(reqs))
    draft = 4 if args.speculative else 0
    slot_counts = [int(s) for s in args.slots_sweep.split(",")] if args.slots_sweep else [args.slots]
    if args.sequential_baseline and 1 not in slot_counts:
        slot_counts = [1] + slot_counts

    # The split pools' geometry from a sample prefill: P = the first layer
    # whose cache is shorter than layer 0's (compression has fired by then),
    # cap = the longest layer from P on, 15% and a bucket of headroom.
    tail_pool = None
    if args.tail_pool:
        inp0 = reqs[0].inputs
        res0 = engine.prefill(inp0.input_embeds, inp0.patch_type, inp0.position_ids, patch_num=inp0.patch_num,
                              image_token_start=inp0.image_token_start,
                              image_token_length=inp0.image_token_length)
        lens0 = [c[2] for c in res0.layer_caches]
        p = next((l for l in range(1, len(lens0)) if lens0[l] < lens0[0]), None)
        if p is not None:
            cap = int(max(lens0[p:]) * 1.15) + engine.ff.bucket
            tail_pool = (p, cap)
            print(f"tail pool: P={p}, tail_prefix_cap={cap} (sample lens {lens0[0]} -> {max(lens0[p:])}; "
                  f"head prefix_cap {prefix_cap})")
        del res0

    def serve_at(slots):
        warm = ServingLoop(engine, max_slots=slots, max_new_cap=args.new_tokens, chunk_steps=args.chunk,
                           draft_len=0, prefix_cap=prefix_cap, tail_pool=tail_pool)
        warm.submit(ServeRequest(reqs[0].inputs, max_new_tokens=4))
        warm.run()
        return run_loop(engine, reqs, arrivals, slots=slots, chunk=args.chunk, max_new=args.new_tokens,
                        prefix_cap=prefix_cap, draft=0, tail_pool=tail_pool)

    sweep_rows = []
    results = dt = main_row = None
    for slots in slot_counts:
        try:
            res_s, dt_s, loop_s = serve_at(slots)
        except torch.OutOfMemoryError as e:  # a B past the memory wall is a row of the sweep
            msg = str(e).split("\n")[0][:200]
            sweep_rows.append({"slots": slots, "infeasible": msg})
            print(f"  B={slots}: INFEASIBLE at this geometry: {msg}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        toks_s = sum(len(r.tokens) for r in res_s.values())
        lat = [res_s[i].queue_s + res_s[i].serve_s for i in res_s]
        row = {"slots": slots, "wall_ms": round(dt_s * 1e3, 1), "tokens": toks_s,
               "tokens_per_s": round(toks_s / dt_s, 1), "chunks": loop_s._chunk_idx,
               "compactions": loop_s.compactions, "queue_ms": percentiles([res_s[i].queue_s for i in res_s]),
               "serve_ms": percentiles([res_s[i].serve_s for i in res_s]), "request_latency_ms": percentiles(lat)}
        sweep_rows.append(row)
        print(f"  B={slots}: {row['wall_ms']:.0f} ms, {row['tokens_per_s']} tok/s, {row['chunks']} chunks, "
              f"{row['compactions']} compactions; latency p50/p95 {row['request_latency_ms']['p50']:.0f}/"
              f"{row['request_latency_ms']['p95']:.0f} ms")
        if slots == args.slots or results is None:
            results, dt, main_row = res_s, dt_s, row
        del loop_s  # free this B's pools before the next allocates
        gc.collect()
    if results is None:
        raise RuntimeError(f"no slot count was feasible: {sweep_rows}")
    ids = list(range(len(reqs)))

    total_toks = sum(len(results[i].tokens) for i in ids)
    print(f"served {len(reqs)} requests through {main_row['slots']} slots in {dt*1e3:.0f} ms: {total_toks} "
          f"tokens, {total_toks/dt:.1f} tok/s, {main_row['chunks']} chunks, {main_row['compactions']} compactions")
    qs = sorted(results[i].queue_s for i in ids)
    ss = sorted(results[i].serve_s for i in ids)
    mid = len(ids) // 2
    print(f"  latency: queue p50 {qs[mid]*1e3:.0f} ms / max {qs[-1]*1e3:.0f} ms; "
          f"serve p50 {ss[mid]*1e3:.0f} ms / max {ss[-1]*1e3:.0f} ms")
    record = {
        "requests": len(reqs), "slots": args.slots, "chunk_steps": args.chunk, "frames": frames,
        "prompt_tokens": int(len(reqs[0].inputs.patch_type)), "backend": engine.device.type,
        "device": device_label(engine.device), "int8": bool(args.int8),
        "tail_pool": list(tail_pool) if tail_pool else None, "arrival_rate_per_s": args.arrival_rate,
        "arrival_span_ms": round(float(arrivals[-1]) * 1e3, 1), "total_tokens": total_toks,
        "wall_ms": round(dt * 1e3, 1), "serving_tokens_per_s": round(total_toks / dt, 1),
        "queue_ms_p50": round(qs[mid] * 1e3, 1), "queue_ms_max": round(qs[-1] * 1e3, 1),
        "serve_ms_p50": round(ss[mid] * 1e3, 1), "serve_ms_max": round(ss[-1] * 1e3, 1),
        "chunks": main_row["chunks"], "compactions": main_row["compactions"], "slots_sweep": sweep_rows,
        "reading_note": (
            "Wall times are the host clock around the loop, which synchronizes with the card at each "
            "chunk's read. Each admission runs a whole compressed prefill between chunks, so at long "
            "prompts the workload is prefill-bound and the batching gain is bounded by the decode's share; "
            "the chunk counts (about inverse in B), the compactions and the queue-against-serve split under "
            "Poisson arrivals are the steadier signals. An infeasible slots row marks the memory wall."),
    }
    base1 = next((r for r in sweep_rows if r["slots"] == 1 and "wall_ms" in r), None)
    if base1 is not None:
        for r in sweep_rows:
            if "wall_ms" in r:
                r["batching_speedup"] = round(base1["wall_ms"] / r["wall_ms"], 3)
        record.update({"sequential_wall_ms": base1["wall_ms"], "sequential_tokens_per_s": base1["tokens_per_s"],
                       "batching_speedup": round(base1["wall_ms"] / record["wall_ms"], 3)})
        print(f"  sequential 1-slot baseline: {base1['wall_ms']:.0f} ms, {base1['tokens_per_s']} tok/s; "
              f"continuous-batching speedup {record.get('batching_speedup')}x")
    if args.speculative:
        # Oracle-seeded: each request's own plain output is its lookup
        # history, so drafts hit (the ceiling of speculative serving; cold
        # prompt lookup on random prompts has no repeated n-grams to draft).
        spec_reqs = [ServeRequest(r.inputs, max_new_tokens=r.max_new_tokens,
                                  prompt_ids=np.asarray(results[i].tokens, np.int32)) for i, r in zip(ids, reqs)]
        sloop = ServingLoop(engine, max_slots=args.slots, max_new_cap=args.new_tokens, chunk_steps=args.chunk,
                            draft_len=draft, prefix_cap=prefix_cap, tail_pool=tail_pool)
        sids = [sloop.submit(r) for r in spec_reqs]
        t0 = time.perf_counter()
        sresults = sloop.run()
        ds = time.perf_counter() - t0
        stoks = sum(len(sresults[i].tokens) for i in sids)
        agree = sum(a == b for i, j in zip(sids, ids) for a, b in zip(sresults[i].tokens, results[j].tokens))
        print(f"  oracle-seeded speculative: {ds*1e3:.0f} ms, {stoks} tokens, {stoks/ds:.1f} tok/s, "
              f"{sloop._chunk_idx} chunks; agreement {agree}/{total_toks} vs plain")
        record.update({"speculative_wall_ms": round(ds * 1e3, 1), "speculative_tokens_per_s": round(stoks / ds, 1),
                       "speculative_agreement": f"{agree}/{total_toks}"})

    for i in ids[:min(4, len(ids))]:
        r = results[i]
        print(f"  req {i}: admitted@chunk {r.admitted_step}, {len(r.tokens)} tokens, prefill={r.prefill_mode}, "
              f"first: {r.tokens[:6]}")

    # Request 0 against its solo greedy decode. The serving chunk decodes
    # through the batched step, the solo decode through the one-row step:
    # on the card their bf16 sums differ in order and may flip a near-tie
    # of random weights, so the card's gate is token 0; a broken pool bound
    # would corrupt every token after the first.
    inp = reqs[0].inputs
    res = engine.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, patch_num=inp.patch_num,
                         image_token_start=inp.image_token_start, image_token_length=inp.image_token_length)
    solo = engine.generate_greedy(res, reqs[0].max_new_tokens)
    got = results[ids[0]].tokens
    assert got[0] == solo[0], "serving first token diverged from solo greedy"
    prefix = 0
    for a, b in zip(got, solo):
        if a != b:
            break
        prefix += 1
    default_prefix = "1" if engine.device.type == "cuda" else "4"
    min_prefix = min(int(os.environ.get("FF_SERVE_PARITY_MIN_PREFIX", default_prefix)), len(solo))
    assert prefix >= min_prefix, (f"serving diverged from solo greedy at token {prefix} (< {min_prefix}): "
                                  f"{got[:8]} vs {solo[:8]}")
    agree = sum(a == b for a, b in zip(got, solo))
    print(f"parity: request 0 vs solo greedy: prefix {prefix}, agreement {agree}/{len(solo)}")
    record["parity_prefix"] = prefix
    return record, results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--speculative", action="store_true", help="draft_len=4 prompt-lookup speculation a slot")
    ap.add_argument("--int8", action="store_true", help="weight-only int8 decode")
    ap.add_argument("--tiny", action="store_true", help="tiny config (the CPU's)")
    ap.add_argument("--fixed-budget", action="store_true",
                    help="every request decodes exactly --new-tokens (default: uniform in "
                         "[new_tokens/2, new_tokens])")
    ap.add_argument("--sequential-baseline", action="store_true",
                    help="also serve the same requests through a 1-slot loop (the reference's one request at "
                         "a time) and report the continuous-batching speedup")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson request arrivals at this mean rate (req/s); 0 = all queued at t=0")
    ap.add_argument("--tail-pool", action="store_true",
                    help="split the slot pools: layers past the compression phase hold only their compressed "
                         "prefix (P and cap derived from a sample prefill); the same tokens in less memory")
    ap.add_argument("--slots-sweep", type=str, default=None,
                    help="comma-separated slot counts, e.g. 1,2,4,8: the same requests and arrivals at each")
    ap.add_argument("--json", type=str, default=None, help="write the measured numbers to this JSON file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..config import FrameFusionConfig, qwen2_7b_config
    from ..models import qwen2
    from ..runtime.engine import CompressionEngine

    if args.tiny or device.type == "cpu":
        cfg = tiny_config(device, num_layers=4)
        patch_num, frames, prefix_cap = 6, 8, 256
    else:
        cfg = qwen2_7b_config(vocab_size=8192)
        patch_num, frames, prefix_cap = 182, args.frames, 4096
    ff = FrameFusionConfig(cost=0.3, similarity_lower_bound=0.6, ratio_lower_bound=0.1)
    params = qwen2.init_params(cfg, generator(device, 0))
    if args.int8:
        from ..ops.quant import quantize_params_int8

        params = quantize_params_int8(params)
    engine = CompressionEngine(params, cfg, ff, attn_impl="flash" if device.type == "cuda" else "einsum")
    reqs = build_requests(engine, args.requests, frames, patch_num, args.new_tokens, args.fixed_budget)
    record, _ = serve(engine, reqs, args, prefix_cap, frames)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, allow_nan=False)
        print(f"wrote {args.json}")
    return record


if __name__ == "__main__":
    main()
