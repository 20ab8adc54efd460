"""Speculative-decode probe on a TRAINED model: acceptance that means something.

On random weights one bf16 near-tie flip desynchronizes the lookup history,
and the acceptance rate reflects the input, not the machinery. This probe
supplies the missing signal the way ``accuracy_probe`` does for quality:
train a tiny stack on a task whose decode output is a verbatim prompt
n-gram ("echo frames q and q+1" over the same redundant synthetic video),
which is exactly the workload prompt-lookup drafting targets (the
reference decodes one token at a time, with no speculation).

Reported per configuration (dense prefill / FrameFusion-compressed prefill;
solo / batched):
  * greedy_match: speculative output == plain greedy (the invariant);
  * echo_accuracy: the trained model actually performs the task;
  * acceptance: accepted / drafted;
  * tokens_per_weight_pass: decode tokens per verify pass (1.0 = plain
    decode, draft_len+1 = perfect speculation). This is the
    hardware-independent win: each verify pass streams the weights once.

Runs on the card (the engines take the plain fp32 ``"einsum"`` path, as the
JAX probe's do) or with ``--device cpu``:

  python -m framefusion_tpu_torch.scripts.spec_probe --json SPEC.json      # full run
  python -m framefusion_tpu_torch.scripts.spec_probe --steps 200 --eval 8  # smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .accuracy_probe import BOS, N_FRAMES, PATCH_NUM, QUERY_BASE, VOCAB, embed_prompt, make_instance, train
from .common import DeviceTimer, add_device_arg, device_label, resolve_device


def make_echo_instance(rng):
    """Prompt = [BOS] video query(q); answer = video[q] ++ video[q+1]
    (10 tokens, one CONTIGUOUS prompt substring — q < N_FRAMES-1)."""
    ids, _, _ = make_instance(rng)  # reuse the video generator
    video = ids[1 : 1 + N_FRAMES * PATCH_NUM].reshape(N_FRAMES, PATCH_NUM)
    q = int(rng.integers(0, N_FRAMES - 1))
    answer = np.concatenate([video[q], video[q + 1]])
    full = np.concatenate([[BOS], video.reshape(-1), [QUERY_BASE + q], answer])
    return full.astype(np.int32), q, answer


def echo_batch(rng, batch, task="recall"):
    """The echo task's training batch (``task`` is ignored: one stream)."""
    return np.stack([make_echo_instance(rng)[0] for _ in range(batch)])


def build_prompt(full, n_answer):
    prompt = full[: len(full) - n_answer]
    patch_type = np.full(len(prompt), -1, np.int32)
    patch_type[1 : 1 + N_FRAMES * PATCH_NUM] = np.tile(np.arange(PATCH_NUM), N_FRAMES)
    pos = np.arange(len(prompt), dtype=np.int32)
    return prompt, patch_type, pos


def _prefill_one(engine, params, cfg, full, *, compressed):
    n_ans = 2 * PATCH_NUM
    prompt, patch_type, pos = build_prompt(full, n_ans)
    h = embed_prompt(params, prompt)
    if compressed:
        res = engine.prefill(h, patch_type, pos, patch_num=PATCH_NUM, image_token_start=1,
                             image_token_length=N_FRAMES * PATCH_NUM)
    else:
        res = engine.dense_prefill(h, pos)
    return res, prompt


def run_config(engine, params, cfg, instances, *, compressed, draft_len, batched):
    n_ans = 2 * PATCH_NUM
    results, prompts, answers, greedy = [], [], [], []
    for full, _, answer in instances:
        res, prompt = _prefill_one(engine, params, cfg, full, compressed=compressed)
        greedy.append(engine.generate_greedy(res, n_ans))
        # a fresh prefill for the speculative decode, as the JAX probe does
        res, _ = _prefill_one(engine, params, cfg, full, compressed=compressed)
        results.append(res)
        prompts.append([int(t) for t in prompt])
        answers.append(answer)

    if batched:
        toks, stats = engine.generate_spec_batch(results, n_ans, draft_len=draft_len, prompt_ids=prompts,
                                                 return_stats=True)
        spec = [[int(t) for t in row] for row in toks]
    else:
        spec, macro, drafted, accepted = [], 0, 0, 0
        for res, prompt in zip(results, prompts):
            t, st = engine.generate_spec(res, n_ans, draft_len=draft_len, prompt_ids=prompt, return_stats=True)
            spec.append([int(x) for x in t])
            macro += int(st["macro_steps"])
            drafted += int(st["drafted"])
            accepted += int(st["accepted"])
        stats = {"macro_steps": macro, "drafted": drafted, "accepted": accepted}

    def total(v):
        # batched stats are per-sequence lists; solo are scalars
        return int(np.sum(np.asarray(v)))

    stats = {k: total(v) for k, v in stats.items() if k in ("macro_steps", "drafted", "accepted")}
    n = len(instances)
    match = all(s == g for s, g in zip(spec, greedy))
    echo_acc = float(np.mean([np.mean(np.asarray(s) == a) for s, a in zip(spec, answers)]))
    macro = int(stats["macro_steps"])
    row = {
        "greedy_match": bool(match),
        "echo_accuracy": round(echo_acc, 3),
        "acceptance": round(int(stats["accepted"]) / max(int(stats["drafted"]), 1), 3),
        "tokens_per_weight_pass": round(n * (n_ans - 1) / max(macro, 1), 2),
        "macro_steps": macro,
        "plain_decode_steps": n * (n_ans - 1),
    }
    row.update(time_config(engine, params, cfg, instances, compressed=compressed, draft_len=draft_len,
                           batched=batched, prompts=prompts))
    return row


def time_config(engine, params, cfg, instances, *, compressed, draft_len, batched, prompts, rounds=3):
    """Time of the DECODE phase, plain vs speculative, over the eval set
    (prefills rebuilt untimed between passes: decode consumes the result's
    pools), with ``DeviceTimer`` (CUDA events on the card, closed by a
    synchronize; the host clock on the CPU). Median of ``rounds`` passes a
    side, after one warm-up pass each (graph captures excluded)."""
    n_ans = 2 * PATCH_NUM
    on_card = engine.device.type == "cuda"

    def fresh_results():
        return [_prefill_one(engine, params, cfg, full, compressed=compressed)[0] for full, _, _ in instances]

    def plain_pass(results):
        if batched:
            return engine.generate_batch(results, n_ans)
        return [engine.generate_greedy(r, n_ans) for r in results]

    def spec_pass(results):
        if batched:
            return engine.generate_spec_batch(results, n_ans, draft_len=draft_len, prompt_ids=prompts)
        return [engine.generate_spec(r, n_ans, draft_len=draft_len, prompt_ids=p) for r, p in zip(results, prompts)]

    plain_pass(fresh_results())
    spec_pass(fresh_results())
    plains, specs = [], []
    for _ in range(rounds):
        rs = fresh_results()
        plains.append(DeviceTimer.once(lambda: plain_pass(rs), on_card)[0])
        rs = fresh_results()
        specs.append(DeviceTimer.once(lambda: spec_pass(rs), on_card)[0])
    tp = sorted(plains)[len(plains) // 2]
    ts = sorted(specs)[len(specs) // 2]
    return {
        "plain_decode_wall_ms": round(tp * 1e3, 1),
        "spec_decode_wall_ms": round(ts * 1e3, 1),
        "wall_speedup": round(tp / ts, 3),
    }


def serving_rows(engine, params, cfg, instances, draft_len, prefill_mode="fused"):
    """Speculative SERVING on the trained stack: the same echo requests
    through ``runtime/serving.ServingLoop`` with draft_len=0 vs
    draft_len>0, lookup histories seeded from each PROMPT's text ids — the
    echo answer is a verbatim prompt substring, so drafting hits for real
    (no oracle seeding). Reports the serve time (``DeviceTimer``), chunks
    (the weight-pass proxy: every chunk is one captured step a chunk and
    one read), throughput and token agreement."""
    from ..models.adapters.common import PrefillInputs
    from ..runtime.serving import ServeRequest, ServingLoop

    n_ans = 2 * PATCH_NUM
    on_card = engine.device.type == "cuda"

    def make_reqs():
        reqs = []
        for full, _, _ in instances:
            prompt, patch_type, pos = build_prompt(full, n_ans)
            inp = PrefillInputs(input_embeds=embed_prompt(params, prompt), patch_type=patch_type,
                                position_ids=pos, patch_num=PATCH_NUM, image_token_start=1,
                                image_token_length=N_FRAMES * PATCH_NUM)
            reqs.append(ServeRequest(inp, max_new_tokens=n_ans, prompt_ids=np.asarray(prompt, np.int32)))
        return reqs

    def serve(draft):
        loop = ServingLoop(engine, max_slots=4, max_new_cap=n_ans, chunk_steps=4, draft_len=draft, prefix_cap=64,
                           prefill_mode=prefill_mode)
        ids = [loop.submit(r) for r in make_reqs()]
        dt, results = DeviceTimer.once(loop.run, on_card)
        return [results[i].tokens for i in ids], dt, loop._chunk_idx

    serve(0)  # warm the plain chunk program
    serve(draft_len)  # warm the speculative chunk program
    plain_toks, plain_dt, plain_chunks = serve(0)
    spec_toks, spec_dt, spec_chunks = serve(draft_len)
    total = sum(len(t) for t in plain_toks)
    agree = sum(a == b for ta, tb in zip(spec_toks, plain_toks) for a, b in zip(ta, tb))
    return {
        "requests": len(instances), "slots": 4, "chunk_steps": 4,
        "max_new_tokens": n_ans, "draft_len": draft_len,
        "plain_wall_ms": round(plain_dt * 1e3, 1),
        "plain_chunks": plain_chunks,
        "plain_tokens_per_s": round(total / plain_dt, 1),
        "spec_wall_ms": round(spec_dt * 1e3, 1),
        "spec_chunks": spec_chunks,
        "spec_tokens_per_s": round(sum(len(t) for t in spec_toks) / spec_dt, 1),
        "serving_wall_speedup": round(plain_dt / spec_dt, 3),
        "agreement": f"{agree}/{total}",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval", type=int, default=16)
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--ff-cost", type=float, default=0.8,
                    help="FrameFusion budget for the aggressive rows (the gentle twin is fixed at 0.95)")
    ap.add_argument("--json", type=str, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..config import FrameFusionConfig, tiny_llm_config
    from ..runtime.engine import CompressionEngine

    cfg = tiny_llm_config(vocab_size=VOCAB)
    print(f"training {cfg.num_layers}L/d{cfg.hidden_size} on two-frame echo ({args.steps} steps x {args.batch}) "
          f"on {device_label(device)} ...")
    curve: list = []
    params, loss = train(cfg, args.steps, args.batch, args.lr, device=device, batch_fn=echo_batch, losses=curve)
    print(f"final loss {loss:.4f}")

    rng = np.random.default_rng(4321)
    instances = [make_echo_instance(rng) for _ in range(args.eval)]

    dense_engine = CompressionEngine(params, cfg, FrameFusionConfig(), attn_impl="einsum")
    ff = FrameFusionConfig(cost=args.ff_cost, similarity_lower_bound=0.6, ratio_lower_bound=0.05,
                           schedule_num_layers=cfg.num_layers)
    ff_engine = CompressionEngine(params, cfg, ff, attn_impl="einsum")
    # Gentle compression twin: a mild budget removes only near-duplicate
    # rows, separating "speculation under compression" from "this probe's
    # verbatim-recall answer is exactly what aggressive merging deletes".
    ff_gentle = FrameFusionConfig(cost=0.95, similarity_lower_bound=0.6, ratio_lower_bound=0.05,
                                  schedule_num_layers=cfg.num_layers)
    ff_gentle_engine = CompressionEngine(params, cfg, ff_gentle, attn_impl="einsum")

    record = {
        "task": "echo frames q,q+1 (10-token contiguous prompt substring) over "
                "redundant synthetic video",
        "model": f"qwen2-tiny {cfg.num_layers}L d{cfg.hidden_size} vocab {VOCAB}",
        "backend": device_label(device),
        "train_steps": args.steps, "first_loss": round(curve[0], 4) if curve else None,
        "final_loss": round(loss, 4),
        "eval_instances": args.eval, "draft_len": args.draft_len,
        "wall_note": (
            "tokens_per_weight_pass and acceptance are the hardware-"
            "independent signal (each verify pass streams the weights once; "
            "at 7B decode is weight-bound, so fewer passes is the time win). "
            "The time columns at this probe's tiny scale (CUDA events on the "
            "card) are launch- and host-bound: a pass of the tiny model costs "
            "far less than its launches, so they say little about 7B."),
        "reading_note": (
            "The speculative invariant (greedy_match) holds in every row; "
            "acceptance tracks the MODEL'S output regularity, not the "
            f"machinery. The framefusion rows at cost {args.ff_cost} can score "
            "low echo_accuracy because this probe's answer is a verbatim copy "
            "of the queried frames' tokens and merging near-duplicate frames "
            "on a deliberately redundant video deletes exactly the queried "
            "distinction; their acceptance then follows from the broken echo, "
            "not from speculation. framefusion_gentle (cost 0.95) shows how "
            "acceptance moves with the compression level. dense_serving is "
            "the apples-to-apples serving number."),
    }
    for name, eng, compressed, batched in [
        ("dense_solo", dense_engine, False, False),
        ("dense_batched", dense_engine, False, True),
        ("framefusion_solo", ff_engine, True, False),
        ("framefusion_batched", ff_engine, True, True),
        ("framefusion_gentle_solo", ff_gentle_engine, True, False),
    ]:
        r = run_config(eng, params, cfg, instances, compressed=compressed, draft_len=args.draft_len, batched=batched)
        record[name] = r
        print(f"  {name:22s} match={r['greedy_match']} echo_acc={r['echo_accuracy']:.3f} "
              f"acceptance={r['acceptance']:.3f} tok/pass={r['tokens_per_weight_pass']:.2f} "
              f"wall={r['wall_speedup']:.2f}x")

    for name, eng, pmode in [("dense_serving", dense_engine, "dense"),
                             ("framefusion_serving", ff_engine, "fused"),
                             ("framefusion_gentle_serving", ff_gentle_engine, "fused")]:
        r = serving_rows(eng, params, cfg, instances, args.draft_len, prefill_mode=pmode)
        record[name] = r
        print(f"  {name:22s} wall={r['serving_wall_speedup']:.2f}x "
              f"chunks {r['plain_chunks']}->{r['spec_chunks']} "
              f"tok/s {r['plain_tokens_per_s']}->{r['spec_tokens_per_s']} "
              f"agreement={r['agreement']}")

    json.dumps(record, allow_nan=False)  # strict JSON, or this raises
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, allow_nan=False)
        print(f"wrote {args.json}")
    return record


if __name__ == "__main__":
    main()
