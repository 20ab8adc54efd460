"""Discriminating quality probe: trained-model answer accuracy vs compression.

Random weights carry no answer, so greedy agreement with dense says nothing
about what compression destroys (a one-ulp nudge already changes the
tokens). This probe supplies that signal offline, standing in for the
reference's lmms-eval accuracy story, which needs real checkpoints:

1. TRAIN a tiny Qwen2 stack (``parallel/train.py``) on a structured
   video-QA task, per-frame color recall over redundant synthetic "video",
   until dense greedy answers are perfect AND stable under a one-ulp input
   nudge (the metric is no longer chaotic).
2. Sweep FrameFusion's aggressiveness (``cost``) and report answer accuracy
   and token reduction at each point: a number that MOVES when compression
   grows more aggressive and stays when it does not.

Task design (why it discriminates): each frame carries one COLOR token
inside otherwise frame-persistent filler; the query names a frame index and
the answer is that frame's color. Colors persist across adjacent frames
with p = 0.6, so merging truly redundant patches is harmless, but
aggressive schedules must merge or prune frames whose colors DIFFER,
destroying exactly the per-frame information the query needs: accuracy
degrades with aggressiveness instead of cliffing at the first perturbation.

Second task (``--task transitions``): the query asks HOW MANY TIMES the
color CHANGED across the video, an AGGREGATE answer no single token
carries. Single-needle recall with the query visible at prune time makes
last-token attention an oracle for exactly the needed token (FastV's
criterion), whereas the paper's central claim concerns questions over many
frames (its multi-frame video-QA evaluation, e.g. counting and ordering
events). Transition counting is the sharpest offline instance of that
claim: FrameFusion's patch-major similarity merging coalesces WITHIN-run
color tokens only (adjacent same-color frames are the similar pairs),
keeping the run boundaries the answer is computed from, while
attention-ranked pruning removes individual frames and corrupts the count.

Runs on the card (the engines take the plain fp32 ``"einsum"`` path, as the
JAX probe's do: the model's head dim of 32 is no kernel's) or with
``--device cpu``:

  python -m framefusion_tpu_torch.scripts.accuracy_probe --json ACC.json          # full run
  python -m framefusion_tpu_torch.scripts.accuracy_probe --task transitions --json ...
  python -m framefusion_tpu_torch.scripts.accuracy_probe --steps 80 --eval 16     # smoke

``--weights W.npz`` evaluates trained weights instead of training (one
array a leaf of the params tree, keys joined by "/", e.g.
``layers/wq``): the same sweep on weights another run trained, so that
two implementations can be compared on equal weights.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from .common import add_device_arg, device_label, resolve_device

# Vocab layout
BOS = 0
COLOR_BASE, N_COLORS = 1, 8
FILLER_BASE, N_FILLER = 16, 16
QUERY_BASE = 40  # + frame index
COUNT_BASE = 48  # + transition count (0..N_FRAMES-1); transitions-task answers
TRANS_QUERY = 56  # "how many times did the color change?"
VOCAB = 64

N_FRAMES = 8
PATCH_NUM = 5  # tokens per frame; color lives at in-frame slot 2
COLOR_SLOT = 2


def make_instance(rng, task="recall"):
    """One task instance: (token ids incl. answer, queried frame, answer id).

    The queried frame is the index the recall query names; the transitions
    task queries no single frame and returns -1 in its place."""
    fillers = rng.integers(FILLER_BASE, FILLER_BASE + N_FILLER, size=PATCH_NUM)
    colors = np.empty(N_FRAMES, np.int64)
    colors[0] = rng.integers(0, N_COLORS)
    for f in range(1, N_FRAMES):
        colors[f] = colors[f - 1] if rng.random() < 0.6 else rng.integers(0, N_COLORS)
    video = np.empty((N_FRAMES, PATCH_NUM), np.int64)
    for f in range(N_FRAMES):
        # filler persists across frames with occasional redraws -> high
        # adjacent-frame similarity, like real video
        redraw = rng.random(PATCH_NUM) < 0.1
        fillers = np.where(redraw, rng.integers(FILLER_BASE, FILLER_BASE + N_FILLER, size=PATCH_NUM), fillers)
        video[f] = fillers
        video[f, COLOR_SLOT] = COLOR_BASE + colors[f]
    if task == "transitions":
        q, answer = -1, COUNT_BASE + int(np.sum(colors[1:] != colors[:-1]))
        q_tok = TRANS_QUERY
    else:
        q = int(rng.integers(0, N_FRAMES))
        answer, q_tok = int(COLOR_BASE + colors[q]), QUERY_BASE + q
    ids = np.concatenate([[BOS], video.reshape(-1), [q_tok], [answer]])
    return ids.astype(np.int32), q, answer


def make_batch(rng, batch, task="recall"):
    return np.stack([make_instance(rng, task)[0] for _ in range(batch)])


def train(cfg, steps, batch, lr, seed=0, log_every=200, task="recall", device=None, batch_fn=None, losses=None):
    """Train a fresh stack (drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``) for ``steps`` AdamW steps on
    ``batch_fn(rng, batch, task)`` (``make_batch`` by default), rng the numpy
    stream seeded with ``seed``. Returns (params, final loss); ``losses``, a
    list, collects every step's loss (one read at the end)."""
    from .. import weights
    from ..models import qwen2
    from ..parallel.train import make_optimizer, make_train_step, tree_map

    device = weights.resolve_device(device)
    batch_fn = batch_fn or make_batch
    params = qwen2.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    train_step, init = make_train_step(cfg, device, make_optimizer(lr))
    params, opt_state = init(params)
    rng = np.random.default_rng(seed)
    step_losses = []
    for step in range(steps):
        ids = torch.from_numpy(batch_fn(rng, batch, task)).to(device)
        params, opt_state, loss = train_step(params, opt_state, ids)
        step_losses.append(loss)
        if log_every and (step + 1) % log_every == 0:
            print(f"  step {step+1}/{steps} loss {float(loss):.4f}")
    curve = torch.stack(step_losses).tolist() if step_losses else []
    if losses is not None:
        losses.extend(curve)
    return tree_map(torch.Tensor.detach, params), (curve[-1] if curve else float("nan"))


def load_weights(path, device=None):
    """The params of an .npz written one array a leaf (keys like
    ``layers/wq``), on ``device``."""
    from ..models import qwen2

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *outer, leaf = key.split("/")
            node = tree
            for k in outer:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return qwen2.params_from_numpy(tree, device)


def build_prompt(ids_with_answer):
    """Engine inputs for one instance (prompt excludes the answer token)."""
    prompt = ids_with_answer[:-1]
    patch_type = np.full(len(prompt), -1, np.int32)
    patch_type[1 : 1 + N_FRAMES * PATCH_NUM] = np.tile(np.arange(PATCH_NUM), N_FRAMES)
    pos = np.arange(len(prompt), dtype=np.int32)
    return prompt, patch_type, pos


def embed_prompt(params, prompt):
    from ..models import qwen2

    return qwen2.embed(params, torch.from_numpy(np.asarray(prompt, np.int64)).to(params["embed"].device))


def evaluate(engine, params, cfg, instances, compressed, nudge=False, per_instance=None):
    """Answer accuracy of the first greedy token; optionally on a one-ulp
    nudged input (the stability/noise-floor measurement). ``per_instance``,
    a list, collects each compressed prefill's reduction."""
    hits, reductions = 0, []
    for ids, _, answer in instances:
        prompt, patch_type, pos = build_prompt(ids)
        h = embed_prompt(params, prompt)
        if nudge:
            h = h * torch.tensor(1.0 + 2.0 ** -7, dtype=h.dtype, device=h.device)
        if compressed:
            res = engine.prefill(h, patch_type, pos, patch_num=PATCH_NUM, image_token_start=1,
                                 image_token_length=N_FRAMES * PATCH_NUM)
            reductions.append(engine_reduction(res))
        else:
            res = engine.dense_prefill(h, pos)
        tok = engine.generate_greedy(res, 1)[0]
        hits += int(tok == answer)
    acc = hits / len(instances)
    if per_instance is not None:
        per_instance.extend(reductions)
    return acc, (float(np.mean(reductions)) if reductions else 0.0)


def all_removed(reductions) -> int:
    """Prefills that removed every image token. The schedule asks for that
    when the events before the prune spent the budget exactly: a ratio of
    1, or 0 / 0 where they also used every scheduled layer, which the fused
    and planned executors keep as 0 tokens, as JAX's phase programs do."""
    return sum(r == 1.0 for r in reductions)


def engine_reduction(res):
    return float(res.telemetry.vision_token_reduction)


READING_NOTES = {
    "recall": (
        "Scale caveat for the FastV rows: this probe is single-token needle "
        "recall with the query visible at prune time, on a small OVERFIT "
        "stack — the last-token attention FastV prunes by is then an oracle "
        "for exactly the needed token, while FrameFusion's similarity "
        "merging is query-blind by design. The paper's regime (28-layer "
        "general VLMs, noisy early-layer attention, questions over many "
        "frames) is where it reports the opposite ordering; validating that "
        "ordering needs real checkpoints + lmms-eval (environment-gated). "
        "What this probe establishes offline: how FrameFusion's accuracy "
        "moves with cost, and where it sits against StreamingLLM, "
        "fixed-schedule merging and oracle-informed pruning at matched "
        "reduction and at equal cost."),
    "transitions": (
        "Aggregate task: the answer (how many times the color changed) is "
        "carried by no single token, so the last-token attention FastV "
        "prunes by is no oracle here, unlike in the recall task. The rows "
        "compare the methods' criteria against the task's structure: "
        "similarity merging can coalesce runs of one color and keep their "
        "boundaries, while attention-ranked pruning and the StreamingLLM "
        "window drop whole frames and can change the count. On a small "
        "OVERFIT stack; the paper's 28-layer regime needs real checkpoints "
        "+ lmms-eval (environment-gated)."),
}


def baseline_pareto(params, cfg, instances, ff_sweep, targets=(0.3, 0.5, 0.7), task="recall"):
    """Accuracy-vs-reduction curves for the paper's comparison methods at
    MATCHED token reductions: the offline counterpart of the paper's central
    claim that FrameFusion dominates FastV / StreamingLLM / fixed merging at
    equal budget (the baselines library exists for exactly this comparison).

    Matching semantics per method (all evaluated on the SAME trained stack
    and eval instances as the FrameFusion sweep):
      * framefusion: the sweep point whose achieved reduction is closest to
        each target (reduction is data-dependent through ``cost``).
      * fastv: ``fastv_r = target`` removes exactly round(target * img)
        image tokens at layer ``fastv_k``.
      * prefill_merge: fixed similarity-merge schedule over the first two
        layers with per-layer sparsity ``1 - sqrt(1 - target)`` so the total
        removal matches the target.
      * streamingllm: no tokens are removed; the matched budget is the
        attention window, ``length_rate = 1 - target``. Its "reduction"
        column is the attention-budget cut, not token removal, kept because
        the paper compares it at equal compute budget.
    """
    from ..baselines import BaselineEngine

    def cost_from_events(res, img0):
        """Normalized per-layer image-token density (the reference's cost
        unit, compute_density_overhead) reconstructed from a prefill's event
        telemetry: mean over layers of the image density in force at that
        layer (the layer "-1" pre-attention event counts from layer 0 on)."""
        img_at = []
        img = img0
        ev = sorted(res.telemetry.events, key=lambda e: e.layer)
        i = 0
        for l in range(cfg.num_layers):
            while i < len(ev) and ev[i].layer <= l:
                img -= ev[i].tokens_removed
                i += 1
            img_at.append(img / img0)
        return float(np.mean(img_at))

    def eval_engine(engine):
        hits, reductions, costs = 0, [], []
        for ids, _, answer in instances:
            prompt, patch_type, pos = build_prompt(ids)
            h = embed_prompt(params, prompt)
            res = engine.prefill(h, patch_type, pos, PATCH_NUM, 1, N_FRAMES * PATCH_NUM)
            reductions.append(float(res.telemetry.vision_token_reduction))
            costs.append(cost_from_events(res, N_FRAMES * PATCH_NUM))
            tok = engine.generate_greedy(res, 1)[0]
            hits += int(tok == answer)
        return hits / len(instances), float(np.mean(reductions)), float(np.mean(costs))

    pareto = {"targets": list(targets),
              "normalized_cost_note": (
                  "normalized_cost is the reference's cost unit — mean "
                  "per-layer image-token density (compute_density_overhead). "
                  "FrameFusion's schedule enforces it == the cost knob; late "
                  "pruners (FastV) pay full density before layer k, so equal "
                  "REDUCTION costs them more COMPUTE.")}

    # framefusion: nearest sweep point per target (feasible points only).
    # The schedule enforces mean density == the cost knob by construction.
    pts = [dict(p, normalized_cost=p["cost"]) for p in ff_sweep if "accuracy" in p]
    pareto["framefusion"] = [min(pts, key=lambda p: abs(p["token_reduction"] - t)) for t in targets] if pts else []

    rows = []
    for t in targets:
        eng = BaselineEngine(params, cfg, "fastv", {"fastv_k": 2, "fastv_r": t}, attn_impl="einsum")
        acc, red, cost = eval_engine(eng)
        rows.append({"fastv_r": t, "token_reduction": round(red, 3),
                     "normalized_cost": round(cost, 3), "accuracy": round(acc, 3)})
        print(f"  fastv         r={t}: accuracy {acc:.3f} @ {red:.1%} reduction (cost {cost:.2f})")
    pareto["fastv"] = rows

    # FastV at EQUAL COST (the paper's axis): pick (k=1, r) so the mean
    # per-layer density matches the FrameFusion point serving the same
    # target. cost = (1 + (L-1)(1-r))/L  =>  r = 1 - (L*cost - 1)/(L - 1).
    rows = []
    n_l = cfg.num_layers
    for ffp in pareto["framefusion"]:
        c = ffp["normalized_cost"]
        r = min(max(1.0 - (n_l * c - 1.0) / (n_l - 1), 0.0), 1.0)
        eng = BaselineEngine(params, cfg, "fastv", {"fastv_k": 1, "fastv_r": r}, attn_impl="einsum")
        acc, red, cost = eval_engine(eng)
        rows.append({"fastv_k": 1, "fastv_r": round(r, 3), "token_reduction": round(red, 3),
                     "normalized_cost": round(cost, 3), "accuracy": round(acc, 3),
                     "matched_framefusion_cost": c})
        print(f"  fastv=cost    k=1 r={r:.2f}: accuracy {acc:.3f} @ {red:.1%} reduction (cost {cost:.2f} == FF {c})")
    pareto["fastv_equal_cost"] = rows

    rows = []
    for t in targets:
        s = 1.0 - math.sqrt(1.0 - t)
        sparsity = [s, s] + [0.0] * (cfg.num_layers - 2)
        eng = BaselineEngine(params, cfg, "prefill_merge", {"sparsity": sparsity}, attn_impl="einsum")
        acc, red, cost = eval_engine(eng)
        rows.append({"sparsity_per_layer": round(s, 4), "token_reduction": round(red, 3),
                     "normalized_cost": round(cost, 3), "accuracy": round(acc, 3)})
        print(f"  prefill_merge s={s:.3f}x2: accuracy {acc:.3f} @ {red:.1%} reduction (cost {cost:.2f})")
    pareto["prefill_merge"] = rows

    rows = []
    for t in targets:
        eng = BaselineEngine(params, cfg, "streamingllm", {"init_num": 4, "length_rate": 1.0 - t},
                             attn_impl="einsum")
        acc, _, _ = eval_engine(eng)
        rows.append({"length_rate": round(1.0 - t, 3), "attention_budget_cut": t, "accuracy": round(acc, 3)})
        print(f"  streamingllm  rate={1-t:.1f}: accuracy {acc:.3f} @ {t:.0%} attention-budget cut "
              f"(tokens not removed)")
    pareto["streamingllm"] = rows
    pareto["reading_note"] = READING_NOTES[task]
    return pareto


def s_th_ablation(params, cfg, instances, cost=0.3):
    """similarity_lower_bound sweep at FIXED cost (the reference's second
    knob, per-family defaults 0.5-0.7), doubling as the merge-vs-prune EVENT
    ABLATION: the schedule meets the same budget either way (merge while the
    per-event similarity clears S_th and the merge ratio clears r_min, then
    one prune for the remainder), so raising S_th re-apportions the SAME
    token removal from similarity merging toward importance pruning. S_th
    0.0 accepts every merge the schedule asks for (merge-dominated); 1.01
    rejects all of them (a pure FastV-style prune, since cosine similarity
    <= 1). Accuracy per point tells which event type destroys less task
    information at equal budget."""
    from ..config import FrameFusionConfig
    from ..core.schedule import CostInfeasibleError
    from ..runtime.engine import CompressionEngine

    rows = []
    for s_th in (0.0, 0.5, 0.6, 0.7, 0.8, 0.9, 1.01):
        ff = FrameFusionConfig(cost=cost, similarity_lower_bound=s_th, ratio_lower_bound=0.05,
                               schedule_num_layers=cfg.num_layers)
        engine = CompressionEngine(params, cfg, ff, attn_impl="einsum")
        hits, reds, merged, pruned = 0, [], 0, 0
        try:
            for ids, _, answer in instances:
                prompt, patch_type, pos = build_prompt(ids)
                h = embed_prompt(params, prompt)
                res = engine.prefill(h, patch_type, pos, patch_num=PATCH_NUM, image_token_start=1,
                                     image_token_length=N_FRAMES * PATCH_NUM)
                reds.append(engine_reduction(res))
                for e in res.telemetry.events:
                    if e.kind.startswith("merge"):
                        merged += int(e.tokens_removed)
                    else:
                        pruned += int(e.tokens_removed)
                hits += int(engine.generate_greedy(res, 1)[0] == answer)
        except CostInfeasibleError:
            rows.append({"s_th": s_th, "infeasible": True})
            print(f"  s_th={s_th:>4}: infeasible at cost={cost}")
            continue
        removed = max(merged + pruned, 1)
        row = {"s_th": s_th, "accuracy": round(hits / len(instances), 3),
               "token_reduction": round(float(np.mean(reds)), 3),
               "merged_frac": round(merged / removed, 3), "pruned_frac": round(pruned / removed, 3),
               "all_image_tokens_removed": all_removed(reds)}
        rows.append(row)
        print(f"  s_th={s_th:>4}: accuracy {row['accuracy']:.3f} @ {row['token_reduction']:.1%} reduction "
              f"(merge {row['merged_frac']:.0%} / prune {row['pruned_frac']:.0%})")
    return {"cost": cost, "rows": rows,
            "reading_note": (
                "Same normalized-cost budget every row (the schedule "
                "enforces mean per-layer density == cost); S_th only "
                "re-apportions removal between merge events and the prune "
                "event. token_reduction varies because the budget is in "
                "compute units: a pure prune (s_th=1.01) fires once and "
                "must remove MORE tokens than progressive merging to reach "
                "the same mean density. merged_frac/pruned_frac are the "
                "shares of removed tokens per event type over the eval "
                "set.")}


def cost_sweep(params, cfg, instances):
    """FrameFusion's accuracy and reduction at cost 0.9, 0.7, 0.5, 0.3 and
    0.2, and how many prefills removed every image token
    (:func:`all_removed`); the sweep stops at the first infeasible cost (the
    reference raises the same way when the budget cannot be met)."""
    from ..config import FrameFusionConfig
    from ..core.schedule import CostInfeasibleError
    from ..runtime.engine import CompressionEngine

    sweep = []
    for cost in (0.9, 0.7, 0.5, 0.3, 0.2):
        ff = FrameFusionConfig(cost=cost, similarity_lower_bound=0.6, ratio_lower_bound=0.05,
                               schedule_num_layers=cfg.num_layers)
        engine = CompressionEngine(params, cfg, ff, attn_impl="einsum")
        reds: list = []
        try:
            acc, red = evaluate(engine, params, cfg, instances, compressed=True, per_instance=reds)
        except CostInfeasibleError:
            sweep.append({"cost": cost, "infeasible": True})
            print(f"  cost={cost:>4}: infeasible for a {cfg.num_layers}-layer schedule")
            break
        sweep.append({"cost": cost, "accuracy": round(acc, 3), "token_reduction": round(red, 3),
                      "all_image_tokens_removed": all_removed(reds)})
        print(f"  cost={cost:>4}: accuracy {acc:.3f} @ {red:.1%} vision-token reduction")
    return sweep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval", type=int, default=200)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--task", choices=("recall", "transitions"), default="recall",
                    help="recall: per-frame color needle (query-informed "
                         "attention is an oracle — see reading_note); "
                         "transitions: count color changes, the aggregate "
                         "task where no single token carries the answer")
    ap.add_argument("--baselines", action=argparse.BooleanOptionalAction, default=True,
                    help="also sweep FastV/StreamingLLM/prefill_merge at "
                         "matched reductions (the accuracy Pareto)")
    ap.add_argument("--s-th-sweep", action=argparse.BooleanOptionalAction, default=True, dest="s_th_sweep",
                    help="similarity-threshold sweep at fixed cost (the merge-vs-prune event ablation)")
    ap.add_argument("--weights", type=str, default=None,
                    help="evaluate the weights in this .npz (one array a leaf, keys like layers/wq) "
                         "instead of training; --steps, --batch and --lr are then unused")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from ..config import FrameFusionConfig, tiny_llm_config
    from ..runtime.engine import CompressionEngine

    cfg = tiny_llm_config(vocab_size=VOCAB)
    task_desc = "color-transition counting" if args.task == "transitions" else "frame-color recall"
    curve: list = []
    if args.weights:
        print(f"evaluating {args.weights} on {task_desc} on {device_label(device)} ...")
        params, loss = load_weights(args.weights, device), None
    else:
        print(f"training {cfg.num_layers}L/d{cfg.hidden_size} on {task_desc} ({args.steps} steps x {args.batch}) "
              f"on {device_label(device)} ...")
        params, loss = train(cfg, args.steps, args.batch, args.lr, task=args.task, device=device, losses=curve)
        print(f"final loss {loss:.4f}")

    rng = np.random.default_rng(1234)  # eval instances disjoint from training stream
    instances = [make_instance(rng, args.task) for _ in range(args.eval)]

    dense_engine = CompressionEngine(params, cfg, FrameFusionConfig(), attn_impl="einsum")
    dense_acc, _ = evaluate(dense_engine, params, cfg, instances, compressed=False)
    stable_acc, _ = evaluate(dense_engine, params, cfg, instances, compressed=False, nudge=True)
    print(f"dense answer accuracy {dense_acc:.3f}; one-ulp-nudged {stable_acc:.3f} "
          f"(both ~1.0 = metric is no longer chaotic)")

    sweep = cost_sweep(params, cfg, instances)
    pareto = baseline_pareto(params, cfg, instances, sweep, task=args.task) if args.baselines else None

    s_th_rows = None
    if args.s_th_sweep:
        print("similarity-threshold sweep / event ablation (cost=0.3):")
        s_th_rows = s_th_ablation(params, cfg, instances, cost=0.3)

    record = {
        "task": ("color-transition COUNT over redundant synthetic video — "
                 "aggregate answer carried by no single token (8 frames x 5 "
                 "tokens, colors persist p=0.6)" if args.task == "transitions"
                 else "per-frame color recall over redundant synthetic video "
                      "(8 frames x 5 tokens, colors persist p=0.6)"),
        "model": f"qwen2-tiny {cfg.num_layers}L d{cfg.hidden_size} vocab {VOCAB}",
        "device": device_label(device),
        "weights": args.weights,
        "train_steps": 0 if args.weights else args.steps, "first_loss": round(curve[0], 4) if curve else None,
        "final_loss": None if loss is None else round(loss, 4),
        "eval_instances": args.eval,
        "dense_accuracy": round(dense_acc, 3),
        "dense_accuracy_one_ulp_nudge": round(stable_acc, 3),
        "sweep": sweep,
        "pareto": pareto,
        "s_th_sweep": s_th_rows,
    }
    json.dumps(record, allow_nan=False)  # strict JSON, or this raises
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, allow_nan=False)
        print(f"wrote {args.json}")
    return record


if __name__ == "__main__":
    main()
