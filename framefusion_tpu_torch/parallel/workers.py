"""Rank programs for ``launch.spawn``: each rank builds its shard and runs
the engine, the sequence-sharded prefill or the expert-parallel block, and
returns what the caller compares (decisions, logits, tokens) as numpy and
Python values.

``run_jobs(rank, world, device, jobs)`` runs a list of jobs on one spawn,
so a test or a smoke phase pays the ranks' start-up once. A job is a dict
with a ``kind``:

* ``"tp"``: ``params`` (a numpy tree, the whole model, the same on every
  rank) sharded over a ``(data, tensor)`` mesh of ``tensor`` ranks, or
  ``checkpoint`` (an HF directory, ``weights.load_checkpoint(mesh=)``), an
  engine over the shard (``attn_impl``), and its ``steps``: ``prefill``
  (``mode``), ``greedy`` / ``spec`` / ``sampled`` (a prefill, then ``n``
  tokens; ``sampled`` draws on a generator seeded with the rank's place in
  its group), ``dense_greedy`` and ``serve`` (a ``ServingLoop`` over
  several prompts);
* ``"ep"``: the same over a ``(data, expert)`` mesh of ``expert`` ranks
  for a MoE stack;
* ``"seq"``: ``seq_shard.seq_sharded_prefill`` over ``seq`` ranks, gather
  or ``ring``;
* ``"moe_block"``: ``models/moe.moe_mlp(ep=mesh)`` on a block's shard;
* ``"hold"``: rank ``rank`` sleeps ``seconds`` before a barrier of all
  ranks (a slow or hung rank, for ``spawn``'s time limit);
* ``"train"``: ``train.make_train_step`` over a ``(data, tensor)`` mesh of
  ``tensor`` ranks on the shard of ``params``: its AdamW steps (``lr``) on
  ``batches`` (global (B, T) ids), returning the losses, the first step's
  gradients and the final parameters of the rank's shard (numpy); with
  ``probe`` ((B, T, V) weights), first the gradient of ``sum(probe *
  forward_batched(batches[0]))``, the gathered logits under the mesh;
* ``"pipe"``: the same for ``pipeline.make_pipe_train_step`` over a
  ``(data, stage)`` mesh of ``stages`` stages and ``n_micro`` microbatches,
  with ``pipeline_forward`` of ``batches[0]`` before the steps;
* ``"refuse"``: the pipeline's refusals (a batch that does not split into
  the microbatches, layers that do not split over the stages): their
  messages.

On the card at full width (each rank draws its own shard from a seed,
``sharding.init_sharded_params``; the ranks not in ``active`` only join the
mesh, so a 4-rank spawn can run a 2-rank job beside idle replicas):

* ``"full"``: a tensor- (``axis="tensor"``) or expert-parallel
  (``axis="expert"``) engine: a warm-up and a timed fused prefill (events,
  logits, this rank's layer-0 and prune-layer keys), then an int8 decode of
  ``n`` tokens, timed; each with the host seconds spent in collectives,
  each kernel wrapper's launches (its counts set to 0 just before) and
  those launches by call shape (``KernelLog``);
* ``"seq_full"``: the sequence-sharded prefill, gather then ring, timed;
* ``"nccl_one"``: a world of one over NCCL: the engine with a mesh of one
  rank against the engine without, the decode graph captured with its
  all-reduce inside;
* ``"train_full"`` / ``"pipe_full"``: a training step at full width, each
  rank's shard drawn from ``seed`` (its pipeline stage's layers by their
  global index): ``steps`` AdamW steps on one batch drawn from
  ``ids_seed``, each step's loss, ms and collectives (calls and host
  seconds), the peak memory, a digest of each leaf ``digests`` names
  (None: every leaf) to hold the replicated ones bitwise equal across
  ranks, and for a MoE stack ``router_stats`` after the steps;
* ``"nccl_train_one"``: a world of one over NCCL: the training step with a
  mesh of one rank against the step without, from the same weights.

A prompt is ``(input_embeds, patch_type, position_ids, patch_num,
image_token_start, image_token_length)`` as numpy, or ``{"video": kwargs}``:
``build_video_prompt(np.random.default_rng(seed), hidden, **kwargs)``
built on the rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class _Meshes(dict):
    """The meshes of one ``run_jobs`` call, one a (kind, width): every rank
    makes each in the same order."""

    def get_mesh(self, kind: str, width: int, world: int):
        from ..models.moe import make_expert_mesh
        from .pipeline import make_pipe_mesh
        from .seq_shard import make_seq_mesh
        from .sharding import make_mesh

        if (kind, width) not in self:
            make = {"tensor": lambda: make_mesh(world, width),
                    "expert": lambda: make_expert_mesh(world, width, data=world // width),
                    "seq": lambda: make_seq_mesh(world, width),
                    "stage": lambda: make_pipe_mesh(world, width, data=world // width)}[kind]
            self[kind, width] = make()
        return self[kind, width]


def _tensors(tree, device, dtype=None):
    """A numpy tree as torch on ``device``; floats in ``dtype`` when given
    (int8 stays int8)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _inputs(prompt, device, dtype, hidden=None):
    if isinstance(prompt, dict):
        from ..models.adapters.common import build_video_prompt

        kw = dict(prompt["video"])
        h, pt, start, n = build_video_prompt(np.random.default_rng(kw.pop("seed")), hidden, **kw)
        prompt = (h, pt, np.arange(len(pt)), kw.get("patch_num", 182), start, n)
    h, pt, pos, patch_num, start, n = prompt
    return torch.from_numpy(np.asarray(h, np.float32)).to(device, dtype), pt, pos, patch_num, start, n


def result_of(res) -> dict:
    """A prefill result's decisions and logits, for comparing across ranks."""
    tel = res.telemetry
    return {"events": [] if tel is None else [(e.layer, e.kind, e.tokens_removed, e.tokens_after)
                                              for e in tel.events],
            "valid_len": res.valid_len, "lens": [int(c[2]) for c in res.layer_caches],
            "logits": res.logits.float().cpu().numpy(), "mode": res.mode}


def _step(engine, step: dict, device, dtype) -> dict:
    op = step["op"]
    if op == "serve":
        from ..models.adapters.common import PrefillInputs
        from ..runtime.serving import ServeRequest, ServingLoop

        loop = ServingLoop(engine, **step["loop"])
        ids = [loop.submit(ServeRequest(PrefillInputs(*_inputs(p, device, dtype)), max_new_tokens=step["n"]))
               for p in step["prompts"]]
        served = loop.run()
        return {"tokens": [served[i].tokens for i in ids]}
    if op == "dense_greedy":
        h, _, pos, *_ = _inputs(step["prompt"], device, dtype)
        res = engine.dense_prefill(h, pos)
    else:
        res = engine.prefill(*_inputs(step["prompt"], device, dtype), mode=step.get("mode", "fused"))
    out = result_of(res)
    if op in ("greedy", "dense_greedy"):
        out["tokens"] = engine.generate_greedy(res, step["n"])
    elif op == "spec":
        out["tokens"] = engine.generate_spec(res, step["n"], draft_len=step.get("draft_len", 4))
    elif op == "sampled":  # each rank's own generator: the engine samples with its group's first rank's uniforms
        from ..ops.sampling import SamplerConfig

        gen = torch.Generator(device=res.logits.device).manual_seed(engine.scope.groups()[0].rank)
        out["tokens"] = engine.generate(res, step["n"], sampler=SamplerConfig(temperature=step["temperature"]),
                                        generator=gen)
    return out


def _engine_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    import dataclasses

    from ..runtime.engine import CompressionEngine
    from ..weights import load_checkpoint
    from .sharding import shard_params

    cfg, attn_impl = job["cfg"], job.get("attn_impl", "einsum")
    axis, width = ("tensor", job["tensor"]) if job["kind"] == "tp" else ("expert", job["expert"])
    mesh = meshes.get_mesh(axis, width, world)
    if "checkpoint" in job:  # the rank loads its shard itself, into a FrameFusionModel over the mesh
        model = load_checkpoint(job["checkpoint"], dtype=cfg.dtype, device=device, mesh=mesh)
        model = dataclasses.replace(model, ff=job["ff"], attn_impl=attn_impl)
        shard, engine = model.params, model.engine()
    else:
        shard = shard_params(_tensors(job["params"], device, cfg.dtype), cfg, mesh)
        engine = CompressionEngine(shard, cfg, job["ff"], attn_impl=attn_impl, mesh=mesh)
    zero_launches()
    outs = [_step(engine, step, device, cfg.dtype) for step in job["steps"]]
    shapes = {k: tuple((v["q8"] if isinstance(v, dict) else v).shape) for k, v in shard["layers"].items()}
    shapes.update({k: tuple((shard[k]["q8"] if isinstance(shard[k], dict) else shard[k]).shape)
                   for k in ("embed", "lm_head") if k in shard})
    return {"steps": outs, "shapes": shapes, "local_heads": engine.cfg.num_heads, "launches": launches()}


def zero_launches() -> None:
    """Set every kernel wrapper's counts and the step graphs' replay counts
    to 0."""
    from ..ops import kernels
    from ..runtime.decode_graph import StepGraph

    StepGraph.reset_counts()
    for name in kernels.KERNELS:
        w = kernels.wrapper(name)
        w.launches = w.captured = 0


def launches() -> dict:
    """Each kernel's launches that ran since ``zero_launches``: its
    wrapper's eager ones and those the step graphs' replays ran."""
    from ..ops import kernels
    from ..runtime.decode_graph import StepGraph

    return {name: kernels.wrapper(name).launches + StepGraph.replayed[name] for name in kernels.KERNELS}


def _seq_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    from .seq_shard import seq_sharded_prefill

    cfg = job["cfg"]
    mesh = meshes.get_mesh("seq", job["seq"], world)
    params = _tensors(job["params"], device, cfg.dtype)
    h, pt, pos, patch_num, start, n = _inputs(job["prompt"], device, cfg.dtype)
    logits, tel, valid = seq_sharded_prefill(params, cfg, job["ff"], h, pt, pos, patch_num, start, n, mesh,
                                             ring=job.get("ring", False))
    return {"events": [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in tel.events],
            "valid_len": valid, "sparsity": list(tel.sparsity_list), "logits": logits.float().cpu().numpy()}


def _moe_block_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    from ..models.moe import moe_mlp, shard_moe_params

    mesh = meshes.get_mesh("expert", job["expert"], world)
    mp = shard_moe_params(_tensors(job["params"], device), mesh)
    x = torch.from_numpy(job["x"]).to(device)
    y, probs = moe_mlp(mp, x, job["cfg"], capacity=job.get("capacity"), ep=mesh)
    return {"y": y.float().cpu().numpy(), "probs": probs.float().cpu().numpy(),
            "experts": int(mp["w_gate"].shape[0])}


class CallLog:
    """While active, records a key of every call of the entry points
    ``keys`` names in ``module`` (the functions the model calls, which reach
    a kernel's wrapper; the wrapper and its counts are untouched), to split
    a kernel's launches by regime or shape. A call made inside another call
    this log records is that call's. With ``kernels`` (entry point -> the
    kernels it reaches), a call is recorded under (kernel, key) with the
    launches that kernel's wrapper counted during it; without, as one
    launch under its key. A call recorded while a CUDA graph is captured
    runs at each of that graph's replays (``counts``)."""

    def __init__(self, module, keys: dict, kernels: dict | None = None):
        self.module, self.key_of, self.kernels = module, keys, kernels or {}
        self.keys, self.real, self._depth = [], {}, 0

    def __enter__(self):
        from ..ops.kernels import wrapper

        for name, key in self.key_of.items():
            real = self.real[name] = getattr(self.module, name)
            ws = [(kernel, wrapper(kernel)) for kernel in self.kernels.get(name, ())]

            def recorded(*args, _real=real, _key=key, _ws=ws, **kwargs):
                if self._depth:
                    return _real(*args, **kwargs)
                k = _key(*args, **kwargs)
                captured = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
                field = "captured" if captured else "launches"
                before = [getattr(w, field) for _, w in _ws]
                self._depth += 1
                try:
                    out = _real(*args, **kwargs)
                finally:
                    self._depth -= 1
                if not _ws:
                    self.keys.append((k, captured, 1))
                for (kernel, w), n0 in zip(_ws, before):
                    if getattr(w, field) > n0:
                        self.keys.append(((kernel, k), captured, getattr(w, field) - n0))
                return out

            setattr(self.module, name, recorded)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.module, name, real)

    def counts(self, replays: int = 0) -> dict:
        """Launches that ran, by key: an eager call's once, a call recorded
        into the one CUDA graph captured while the log was active once for
        each of that graph's ``replays``."""
        out: dict = {}
        for k, captured, n in self.keys:
            out[k] = out.get(k, 0) + n * (replays if captured else 1)
        return out


class KernelLog:
    """While active, the decoder's kernel launches by (kernel, call shape),
    from each wrapper's own counts (``CallLog`` with ``kernels``): A and B
    by ``("attn", S, Hq, Hk, key_valid given, capture rows)``, C and D by
    ``(entry, rows, K, the stacks' widths, weight dtype)`` (entry "stacked",
    "qkv", "gateup", "head", "routed" or "routed_gateup"), G by
    ``("decode", Hq, Hk, S_view)``."""

    def __init__(self):
        from ..models import qwen2
        from ..ops.kernels import flash_prefill as fp
        from ..ops.kernels import matvec_q8 as mv

        def attn(q, k, v, key_valid=None, num=0):
            return ("attn", q.shape[0], q.shape[1], k.shape[1], key_valid is not None, num)

        def dt(w):
            return "int8" if w.dtype == torch.int8 else "bf16"

        def stacked(entry):
            return lambda x, w, *rest: (entry, x.shape[0], w.shape[-2], (w.shape[-1],), dt(w))

        c, d = ("gemv_stacked",), ("gemv_gateup",)
        self.logs = [
            CallLog(fp, {"flash_causal_attention": attn,
                         "flash_causal_attention_importance": lambda q, k, v, valid_len, num, key_valid=None: attn(
                             q, k, v, key_valid, num)},
                    {"flash_causal_attention": ("flash_attn_fwd",),
                     "flash_causal_attention_importance": ("flash_attn_fwd", "attn_importance_rows")}),
            CallLog(mv, {"matvec_stacked": stacked("stacked"), "matvec_stacked_gateup": stacked("gateup"),
                         "matvec_q8": stacked("head"), "matvec_routed": stacked("routed"),
                         "matvec_routed_gateup": stacked("routed_gateup"),
                         "matvec_stacked_qkv": lambda x, wq, wk, wv, layer: (
                             "qkv", x.shape[0], x.shape[1], (wq.shape[2], wk.shape[2], wv.shape[2]), dt(wq))},
                    {"matvec_stacked": c, "matvec_stacked_qkv": c, "matvec_q8": c, "matvec_routed": c,
                     "matvec_stacked_gateup": d, "matvec_routed_gateup": d}),
            CallLog(qwen2, {"ragged_decode_attention": lambda q, k, v, length: ("decode", q.shape[0], k.shape[1],
                                                                                 k.shape[0])},
                    {"ragged_decode_attention": ("ragged_decode_attn",)})]

    def __enter__(self):
        for lg in self.logs:
            lg.__enter__()
        return self

    def __exit__(self, *exc):
        for lg in reversed(self.logs):
            lg.__exit__(*exc)

    def counts(self, replays: int = 0) -> dict:
        return {k: n for lg in self.logs for k, n in lg.counts(replays).items()}


def _synced(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _max_memory_gb(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 if str(device).startswith("cuda") else 0.0


def _free(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def keys_of(res, layer: int) -> np.ndarray:
    """Layer ``layer``'s cached keys of a prefill result (its live rows), fp32."""
    k, _, n = res.layer_caches[layer]
    return k[:n].float().cpu().numpy()


def _full_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """A full-width engine on the card (module docstring)."""
    import torch.distributed as dist

    from ..runtime.decode_graph import StepGraph
    from ..runtime.engine import CompressionEngine
    from . import collectives
    from .sharding import init_sharded_params

    cfg, axis = job["cfg"], job["axis"]
    mesh = meshes.get_mesh(axis, job["width"], world)
    if dist.get_rank() not in job["active"]:
        return {"active": False}
    out = {"active": True}
    int8_prefill = job.get("int8_prefill", False)
    params = init_sharded_params(cfg, job["seed"], mesh, device=device, int8=int8_prefill,
                                 quantize_lm_head=int8_prefill)
    engine = CompressionEngine(params, cfg, job["ff"], attn_impl="flash", mesh=mesh)
    args = _inputs(job["prompt"], device, cfg.dtype, cfg.hidden_size)
    # The warm-up, a short dense prefill: the kernels load, cuBLAS sets up.
    warm = min(256, args[0].shape[0])
    engine.dense_prefill(args[0][:warm], np.arange(warm))
    zero_launches()
    with KernelLog() as log, collectives.record() as rec:
        t0 = _synced(device)
        res = engine.prefill(*args)
        t1 = _synced(device)
    prune_layer = res.telemetry.tail_start_layer - 1
    out.update(prefill=result_of(res), prefill_ms=(t1 - t0) * 1e3, prefill_collective_ms=rec.seconds * 1e3,
               prefill_calls=log.counts(), prefill_launches=launches(), keys0=keys_of(res, 0),
               keys_prune=keys_of(res, prune_layer), prune_layer=prune_layer, local_cfg=engine.cfg)
    if not int8_prefill:  # the bf16 prefill's caches, decoded with the int8 weights
        del engine, params
        _free(device)
        params = init_sharded_params(cfg, job["seed"], mesh, device=device, int8=True, quantize_lm_head=True)
        engine = CompressionEngine(params, cfg, job["ff"], attn_impl="flash", mesh=mesh)
    n = job["n"]
    zero_launches()
    graph = None
    try:
        # The graph's capture (under NCCL) is inside the log: its calls run at each replay.
        with KernelLog() as log:
            graph = engine._start_decode(res, n, None, None)
            with collectives.record() as rec:
                t0 = _synced(device)
                graph.run(n - 1)
                t1 = _synced(device)
        out.update(tokens=graph.out[:n].tolist(), decode_logits=graph.logits.float().cpu().numpy(),
                   decode_ms_step=(t1 - t0) * 1e3 / (n - 1), decode_collective_ms_step=rec.seconds * 1e3 / (n - 1),
                   decode_calls=log.counts(StepGraph.replays), decode_launches=launches(),
                   captured=graph.graph is not None, replays=StepGraph.replays)
    finally:
        if graph is not None:
            graph.busy = False
    out["max_memory_gb"] = _max_memory_gb(device)
    del engine, params, graph, res
    _free(device)
    return out


def _seq_full_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """The sequence-sharded prefill at full width, gather then ring (module docstring)."""
    import torch.distributed as dist

    from . import collectives
    from .seq_shard import seq_sharded_prefill
    from .sharding import init_sharded_params

    cfg = job["cfg"]
    mesh = meshes.get_mesh("seq", job["width"], world)
    if dist.get_rank() not in job["active"]:
        return {"active": False}
    params = init_sharded_params(cfg, job["seed"], None, device=device)
    args = _inputs(job["prompt"], device, cfg.dtype, cfg.hidden_size)
    out = {"active": True}
    for ring in (False, True):
        with collectives.record() as rec:
            t0 = _synced(device)
            logits, tel, valid = seq_sharded_prefill(params, cfg, job["ff"], *args, mesh, ring=ring)
            t1 = _synced(device)
        out["ring" if ring else "gather"] = {
            "events": [(e.layer, e.kind, e.tokens_removed, e.tokens_after) for e in tel.events], "valid_len": valid,
            "logits": logits.float().cpu().numpy(), "ms": (t1 - t0) * 1e3, "collective_ms": rec.seconds * 1e3}
    out["max_memory_gb"] = _max_memory_gb(device)
    del params
    _free(device)
    return out


def _nccl_one_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """A world of one over NCCL (module docstring): the tokens and the last
    step's logits of the decode graph with and without the mesh."""
    from ..runtime.decode_graph import StepGraph
    from ..runtime.engine import CompressionEngine
    from . import collectives
    from .sharding import init_sharded_params

    cfg = job["cfg"]
    mesh = meshes.get_mesh("tensor", 1, world)
    params = init_sharded_params(cfg, job["seed"], None, device=device, int8=True, quantize_lm_head=True)
    args = _inputs(job["prompt"], device, cfg.dtype, cfg.hidden_size)
    n, out = job["n"], {}
    for name, m in (("alone", None), ("mesh", mesh)):
        engine = CompressionEngine(params, cfg, job["ff"], attn_impl="flash", mesh=m)
        with collectives.record() as every:
            res = engine.prefill(*args)
            StepGraph.reset_counts()
            graph = engine._start_decode(res, n, None, None)
            with collectives.record() as in_replays:
                graph.run(n - 1)
            torch.cuda.synchronize(device)
        out[name] = {"events": result_of(res)["events"], "prefill_logits": res.logits.float().cpu().numpy(),
                     "tokens": graph.out[:n].tolist(), "logits": graph.logits.float().cpu().numpy(),
                     "captured": graph.graph is not None, "replays": StepGraph.replays,
                     "collectives_in_replays": in_replays.calls, "collectives": every.calls}
        graph.busy = False
        del engine, graph, res
    return out


def _hold_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    import torch.distributed as dist

    if dist.get_rank() == job["rank"]:
        time.sleep(job["seconds"])
    dist.barrier()
    return {}


# ---------------------------------------------------------------------------
# Training across ranks


def numpy_tree(tree):
    """A params tree's leaves as fp32 numpy arrays."""
    from .train import tree_map

    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def named_leaves(tree, prefix: str = "") -> dict:
    """``{"/layers/wq": leaf, ...}``: a nested dict's leaves by path."""
    if isinstance(tree, dict):
        return {path: leaf for k, v in tree.items() for path, leaf in named_leaves(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _grads(params):
    from .train import tree_map

    return tree_map(lambda t: (t.grad if t.grad is not None else torch.zeros_like(t)).float().cpu().numpy(), params)


def _place(mesh) -> dict:
    return {name: mesh.get_local_rank(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _train_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """A tiny step over a (data, tensor) or a (data, stage) mesh (module
    docstring)."""
    from . import collectives, pipeline, train
    from .sharding import shard_params

    cfg, pipe = job["cfg"], job["kind"] == "pipe"
    mesh = meshes.get_mesh("stage", job["stages"], world) if pipe else meshes.get_mesh("tensor", job["tensor"], world)
    # A copy: the steps update the leaves in place, and the jobs of one call may share a numpy tree.
    whole = train.tree_map(torch.clone, _tensors(job["params"], device, cfg.dtype))
    shard = pipeline.shard_params_pipe(whole, cfg, mesh) if pipe else shard_params(whole, cfg, mesh)
    opt = train.make_optimizer(job["lr"])
    out = {"place": _place(mesh)}
    if pipe:
        out["logits"] = pipeline.pipeline_forward(shard, job["batches"][0], cfg, mesh,
                                                  job["n_micro"]).float().cpu().numpy()
        step, init = pipeline.make_pipe_train_step(cfg, mesh, job["n_micro"], opt, device=device)
    else:
        step, init = train.make_train_step(cfg, device, opt, mesh=mesh)
    params, state = init(shard)
    if "probe" in job:  # the gradient of sum(forward_batched * probe) over the rank's leaves: through the gather
        from .sharding import local_config, mesh_scope

        with collectives.use(mesh_scope(mesh)):
            logits = train.forward_batched(params, torch.from_numpy(job["batches"][0]).to(device),
                                           local_config(cfg, job["tensor"]))
            (logits * torch.from_numpy(job["probe"]).to(device)).sum().backward()
        out["probe_grads"] = _grads(params)
        state.zero_grad(set_to_none=True)
    losses = []
    for i, ids in enumerate(job["batches"]):
        params, state, loss = step(params, state, torch.from_numpy(ids))
        losses.append(float(loss))
        if i == 0:
            out["grads"] = _grads(params)
    out.update(losses=losses, params=numpy_tree(params))
    return out


def _refuse_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    from . import pipeline

    mesh = meshes.get_mesh("stage", job["stages"], world)
    cfg, params = job["cfg"], _tensors(job["params"], device, job["cfg"].dtype)
    out = {}
    for name, run in (("batch", lambda: pipeline.pipeline_forward(params, job["ids"][:3], cfg, mesh, 2)),
                      ("layers", lambda: pipeline.pipeline_forward(params, job["ids"], cfg.replace(num_layers=6),
                                                                   mesh, 2))):
        try:
            run()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def router_stats(params: dict, ids: torch.Tensor, cfg) -> list:
    """Each MoE layer's ``load_balancing_loss`` over its router's probs and
    top-k choices in a no-grad forward of ``ids`` (every sequence's tokens
    together), and its capacity drops (routed rows, capacity, dropped
    choices a sequence); ``cfg`` is the rank's local config."""
    from ..models import moe, qwen2

    mcfg = moe.MoeConfig(cfg.hidden_size, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size,
                         cfg.num_experts, cfg.num_experts_per_tok, cfg.norm_topk_prob)
    cos, sin = qwen2.positions_cos_sin(torch.arange(ids.shape[1], device=ids.device), cfg)
    layers, out = params["layers"], []
    with torch.no_grad():
        h = qwen2.embed(params, ids)
        for l in range(layers["ln1"].shape[0]):
            lp = qwen2.layer_slice(layers, l)
            h = qwen2.layer_attention(lp, h, cos, sin, cfg)[0]
            _, idx, probs = moe.router_probs(lp, qwen2.rmsnorm(h, lp["ln2"], cfg.rms_norm_eps).flatten(0, 1), mcfg)
            with moe.record_drops() as drops:
                h = qwen2.layer_mlp(lp, h, cfg)
            out.append({"lb_loss": float(moe.load_balancing_loss(probs, idx, mcfg)),
                        "drops": [(rows, c, int(d)) for rows, c, d in drops]})
    return out


def _train_full_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """A full-width step on the card (module docstring)."""
    from . import collectives, pipeline, train
    from .sharding import init_sharded_params, local_config, mesh_scope, shard_axis

    cfg, pipe = job["cfg"], job["kind"] == "pipe_full"
    mesh = meshes.get_mesh("stage", job["stages"], world) if pipe else meshes.get_mesh("tensor", job["tensor"], world)
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats(device)
    t0 = _synced(device)
    params = init_sharded_params(cfg, job["seed"], mesh, device=device)
    opt = train.make_optimizer(job["lr"])
    if pipe:
        step, init = pipeline.make_pipe_train_step(cfg, mesh, job["n_micro"], opt, device=device)
    else:
        step, init = train.make_train_step(cfg, device, opt, mesh=mesh)
    params, state = init(params)
    ids = torch.from_numpy(np.random.default_rng(job["ids_seed"]).integers(0, cfg.vocab_size, job["batch"]))
    out = {"place": _place(mesh), "losses": [], "ms": [], "calls": [], "collective_s": [],
           "wait_s": [], "schedule_s": [], "init_s": _synced(device) - t0}
    for _ in range(job["steps"]):
        with collectives.record() as rec:
            t0 = _synced(device)
            params, state, loss = step(params, state, ids)
            t1 = _synced(device)
        out["losses"].append(float(loss))
        out["ms"].append((t1 - t0) * 1e3)
        out["calls"].append(rec.calls)
        out["collective_s"].append(rec.seconds)
        if pipe:
            out["wait_s"].append(step.stats["wait_s"])
            out["schedule_s"].append(step.stats["schedule_s"])
    t0 = time.perf_counter()
    keep = job.get("digests")
    out["digests"] = {name: _digest(t) for name, t in named_leaves(params).items()
                      if keep is None or name in keep}
    out["digest_s"] = time.perf_counter() - t0
    if cfg.is_moe:
        rows = shard_axis(mesh).rows(ids.to(device))
        with collectives.use(mesh_scope(mesh)):
            out["router"] = router_stats(params, rows, local_config(cfg, job["tensor"]))
    out["max_memory_gb"] = _max_memory_gb(device)
    del params, state, step, init
    _free(device)
    return out


def _nccl_train_one_job(job: dict, world: int, device, meshes: _Meshes) -> dict:
    """A world of one over NCCL: the step with a one-rank mesh against the
    step without, from the same weights; every leaf's digest and the
    losses of each."""
    from . import train

    cfg = job["cfg"]
    mesh = meshes.get_mesh("tensor", 1, world)
    out = {}
    for name, m in (("alone", None), ("mesh", mesh)):
        step, init = train.make_train_step(cfg, device, train.make_optimizer(job["lr"]), mesh=m)
        params, state = init(train.tree_map(torch.clone, _tensors(job["params"], device, cfg.dtype)))
        losses = []
        for ids in job["batches"]:
            params, state, loss = step(params, state, torch.from_numpy(ids))
            losses.append(float(loss))
        out[name] = {"losses": losses, "digests": {n: _digest(t) for n, t in named_leaves(params).items()}}
    return out


JOBS = {"tp": _engine_job, "ep": _engine_job, "seq": _seq_job, "moe_block": _moe_block_job, "hold": _hold_job,
        "full": _full_job, "seq_full": _seq_full_job, "nccl_one": _nccl_one_job, "train": _train_job,
        "pipe": _train_job, "refuse": _refuse_job, "train_full": _train_full_job, "pipe_full": _train_full_job,
        "nccl_train_one": _nccl_train_one_job}


def run_jobs(rank: int, world: int, device: str, jobs: list) -> list:
    """Every job in order on this rank (module docstring); each result
    carries the job's wall seconds on this rank."""
    out, meshes = [], _Meshes()
    for job in jobs:
        t0 = time.perf_counter()
        res = JOBS[job["kind"]](job, world, device, meshes)
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out
