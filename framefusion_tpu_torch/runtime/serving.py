"""Continuous-batching serving loop (port of ``framefusion_tpu.runtime.serving``).

The batch is a fixed set of ``max_slots`` SLOTS in batched pools
(L, B, S_pool, Hk, hd); requests join a running batch as others finish,
and every request's tokens are exactly its solo greedy decode.

* **Chunks.** The loop decodes ``chunk_steps`` macro steps, then reads the
  device once (emitted, active, the write cursor) to retire finished slots
  and admit queued requests with the engine's own solo prefill. A macro
  step is ``spec_decode.spec_macro_step`` with the budget and eos clamps
  and the bookkeeping of JAX's ``_serve_chunk`` body, captured as one CUDA
  graph (``_ServeChunk``) and replayed ``chunk_steps`` times; JAX's loop
  ends early once no slot is active, so each replay is gated on the device
  by ``any(active)``: a replay after that commits nothing, writes no row
  and leaves the cursor where it was.
* **Per-slot committed-row bitmaps.** Every step writes each slot's K rows
  at the common ``cursor`` and marks only the committed ones in ``dmask``
  (B, S_pool), so a slot admitted mid-stream never sees another's rows.
* **Region recycling.** When the next chunk would not fit, ``_compact_pools``
  packs every slot's live rows (its ragged prefix, then its committed
  decode rows, in order) back below ``region_start``: rotary phases are in
  the stored keys, so moving rows is free. It writes back into the same
  storage, one layer at a time, because the captured graphs hold the
  pools' addresses.
* **Speculative serving.** ``draft_len > 0`` makes each step a
  draft-and-verify macro step: all slots' K rows in one pass.
* ``tail_pool=(P, tail_prefix_cap)``: layers >= P in a smaller array sized
  for their post-compression prefixes (``qwen2.verify_step_batch``'s
  ``phys``); the same tokens.

Every buffer a step reads or writes is allocated once, by the loop: the
graphs (one per tail split, which changes only at admissions) are
captured over them, and admissions, retirements and compactions write into
them in place. JAX asserts where the port raises ``ValueError``
(capacities, budgets), and it serves StreamingLLM's sink-cache decode
through the full-cache verify; the port refuses that engine, as its
``generate_spec`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import bucket_length
from ..parallel import collectives
from .decode_graph import StepGraph
from .engine import best_tail_split_batch
from .profiling import span
from .spec_decode import spec_macro_step, update_rows

__all__ = ["ServeRequest", "ServeResult", "ServingLoop"]


@dataclasses.dataclass
class ServeRequest:
    """One serving request: prefill inputs and its decode contract."""

    inputs: object  # models.adapters.common.PrefillInputs
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    prompt_ids: Optional[object] = None  # text ids seeding the lookup drafter


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: list
    prefill_mode: str
    admitted_step: int  # chunk index at admission
    # Host perf_counter seconds: queue_s from submit to the end of the
    # admission (its prefill and splice included), serve_s from there to
    # retirement; both move in steps of a chunk. queue_s is wait_s, submit
    # to the admission's start, plus admit_s, the admission's host seconds.
    queue_s: float = 0.0
    serve_s: float = 0.0
    wait_s: float = 0.0
    admit_s: float = 0.0
    # The prefill's telemetry: the prompt's length, the tokens it kept, the
    # share of video tokens removed and [(layer, kind, tokens_removed)] of
    # each compression event (a dense prefill keeps every token).
    prompt_len: int = 0
    kept_len: int = 0
    vision_token_reduction: float = 0.0
    events: list = dataclasses.field(default_factory=list)


def _first_eos_clamp(t, n_new, eos_ids, kq: int):
    """Clamp each slot's commit count at the first eos among its committed
    rows; returns (n_new, hit)."""
    row = torch.arange(kq, device=t.device)[None]
    hit_rows = (t == eos_ids[:, None]) & (row < n_new[:, None]) & (eos_ids[:, None] >= 0)
    any_hit = hit_rows.any(dim=1)
    first = torch.argmax(hit_rows.to(torch.int64), dim=1)
    return torch.where(any_hit, first + 1, n_new), any_hit


def _splice_slot(engine, result, k_pool, v_pool, slot: int) -> list:
    """Write one sequence's caches into pool column ``slot`` in place
    (``make_decode_state``'s column fill); returns its per-layer lengths."""
    return engine.make_decode_state(result, 0, pools=(k_pool, v_pool), column=slot)[2]


def _compact_pools(k_pool, v_pool, cache_lens, dmask, region_start: int) -> None:
    """Pack each slot's live rows back into the prefix region, in place.

    Live = the ragged prefix ``[0, cache_lens[l, b])`` plus the slot's
    committed rows (``dmask``) at or past ``region_start``; both keep their
    order and the dead rows sink to the tail (one argsort a layer: the keys
    are distinct, so any sort gives JAX's order). Each layer is gathered
    and copied back into the same storage. ``cache_lens`` grows by each
    slot's committed count and ``dmask`` is cleared."""
    n_layers, b, s = k_pool.shape[:3]
    pos = torch.arange(s, device=k_pool.device)
    committed = dmask & (pos[None, :] >= region_start)  # (B, S)
    for layer in range(n_layers):
        prefix = pos[None, :] < cache_lens[layer][:, None]
        keys = torch.where(prefix, pos, torch.where(committed, s + pos, 2 * s + pos))
        order = torch.argsort(keys, dim=-1)[:, :, None, None].expand(-1, -1, *k_pool.shape[3:])
        for pool in (k_pool, v_pool):
            pool[layer].copy_(torch.gather(pool[layer], 1, order))
    cache_lens.add_(committed.sum(dim=1)[None, :])
    dmask.zero_()


class _ServeChunk(StepGraph):
    """One macro step of the serving chunk over the loop's buffers, for one
    tail split: captured on the card (the warm-up computes a step and
    commits nothing, so the live state stays as it was), eager on the
    CPU."""

    def __init__(self, loop: "ServingLoop", split):
        self.loop, self.split = loop, split
        self._setup(loop.k_pool.device, warmup=lambda: loop._macro_step(split, commit=False))

    def _step(self) -> None:
        self.loop._macro_step(self.split)


class ServingLoop:
    """Continuous-batching scheduler over one ``CompressionEngine``.

    Usage::

        loop = ServingLoop(engine, max_slots=4, max_new_cap=64)
        ids = [loop.submit(ServeRequest(inputs, max_new_tokens=32)) for ...]
        results = loop.run()          # drain the queue and the slots
        results[ids[0]].tokens

    ``submit`` only queues; the device work happens in ``run`` (or
    ``step()``, one chunk at a time). Requests are admitted FIFO into free
    slots, each through the engine's solo prefill (``prefill_mode``); their
    tokens are exactly the solo ``generate_greedy`` output.
    ``draft_len > 0`` serves speculatively. ``tail_pool=(P,
    tail_prefix_cap)`` gives layers >= P a smaller pool (a split that would
    save nothing keeps the uniform layout); admission refuses a request
    whose layers >= P hold more than ``tail_prefix_cap`` rows.

    Introspection: ``compactions``, ``captures`` and ``capture_s`` (the
    chunk graphs made and the seconds their warm-up and capture took); each
    ``ServeResult``'s queue wait, admission seconds and compressed length;
    and, under a ``torch.profiler`` window, ``profiling.span`` ranges:
    ``serve.submit#rid``, ``serve.step`` > ``serve.admit#rid`` (>
    ``engine.prefill``, ``serve.splice``) and ``serve.chunk#active`` (>
    ``serve.compact``, ``serve.capture``, ``serve.upload``,
    ``serve.replay``, ``serve.read``, ``serve.retire#rid``).
    """

    def __init__(self, engine, max_slots: int = 4, max_new_cap: int = 64, chunk_steps: int = 8, draft_len: int = 0,
                 prefix_cap: Optional[int] = None, prefill_mode: str = "fused", seed_cap: int = 256,
                 tail_pool: Optional[tuple] = None):
        guard = getattr(engine, "_guard_spec_sink", None)
        if guard is not None:
            guard()  # the verify pass attends the full cache: no windowed sink-cache decode
        self.engine = engine
        cfg = self.cfg = engine.cfg
        dev = engine.device
        self.b, self.chunk, self.draft_len, self.kq = max_slots, chunk_steps, draft_len, draft_len + 1
        self.max_new_cap, self.prefill_mode, self.seed_cap = max_new_cap, prefill_mode, seed_cap
        # Position streams of the prompts (3 for mRoPE). The chunk step
        # decodes with 1D rotary at each slot's ``pos_base``: one position
        # tiled over the streams is 1D RoPE value for value.
        self.pos_dims = 3 if cfg.mrope_section is not None else 1
        self.attn_impl = engine._verify_impl()
        # [0, region_start) holds compacted live rows (the longest prefix
        # plus a full budget); the scratch tail one chunk of writes.
        self.prefix_cap = prefix_cap or 2048
        self.region_start = bucket_length(self.prefix_cap + max_new_cap, engine.ff.bucket)
        self.scratch = self.chunk * self.kq
        self.s_pool = self.region_start + bucket_length(self.scratch, engine.ff.bucket)

        self.tail_layers, self.tail_prefix_cap, self.phys = 0, None, None
        if tail_pool is not None:
            p, tail_prefix_cap = tail_pool
            if not 0 < p < cfg.num_layers:
                raise ValueError(f"tail_pool {tail_pool}: P must be in [1, {cfg.num_layers - 1}]")
            tail_rs = bucket_length(tail_prefix_cap + max_new_cap, engine.ff.bucket)
            if tail_rs < self.region_start:  # a degenerate split saves nothing
                self.tail_layers, self.tail_prefix_cap, self.tail_rs = int(p), int(tail_prefix_cap), int(tail_rs)
                self.s_tail = tail_rs + (self.s_pool - self.region_start)
                self.phys = (int(p), int(tail_rs), int(self.region_start))

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        head = self.tail_layers or cfg.num_layers
        self.k_pool = zeros(head, self.b, self.s_pool, cfg.num_kv_heads, cfg.head_dim_, dtype=cfg.dtype)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.k_tail = self.v_tail = None
        if self.phys is not None:
            self.k_tail = zeros(cfg.num_layers - self.tail_layers, self.b, self.s_tail, cfg.num_kv_heads,
                                cfg.head_dim_, dtype=cfg.dtype)
            self.v_tail = torch.zeros_like(self.k_tail)
        self.cache_lens = zeros(cfg.num_layers, self.b)
        self.dmask = zeros(self.b, self.s_pool, dtype=torch.bool)
        self.cursor = zeros()
        self.cursor.fill_(self.region_start)
        self._cursor = self.region_start  # the host's copy, read with each chunk's state
        self.hist = zeros(self.b, seed_cap + max_new_cap + self.kq + 1)
        self.hist_len = zeros(self.b)
        self.out = zeros(self.b, max_new_cap + self.kq)
        self.last_tok = zeros(self.b)
        # Per-slot state the host sets at admission and reads after each
        # chunk; uploaded to the device buffers before each chunk.
        self.emitted = np.zeros((self.b,), np.int64)
        self.active = np.zeros((self.b,), bool)
        self.budgets = np.zeros((self.b,), np.int64)
        self.eos_ids = np.full((self.b,), -1, np.int64)
        self.pos_bases = np.zeros((self.b,), np.int64)
        self.emitted_d, self.budgets_d, self.eos_d, self.pos_d = zeros(self.b), zeros(self.b), zeros(self.b), \
            zeros(self.b)
        self.active_d = zeros(self.b, dtype=torch.bool)

        self._queue: list = []
        self._slot_req = [None] * self.b  # request id in each slot
        # Per-slot per-layer prefix lengths at admission: with max_new_cap
        # they bound every layer's live prefix (compaction folds at most
        # max_new_cap committed rows in), the tail split's bound.
        self._admit_lens = [[0] * cfg.num_layers for _ in range(self.b)]
        # Each slot's result, filled at admission and completed at
        # retirement, and the perf_counter time its admission ended.
        self._slot_result: list = [None] * self.b
        self._admitted_at = [0.0] * self.b
        self._results: dict = {}
        self._next_id = 0
        self._chunk_idx = 0
        # The held tail split: recomputed at the step after an admission,
        # the only event that changes the per-layer bounds.
        self._tail_split = None
        self._tail_split_stale = True
        self._graphs: dict = {}  # tail split -> its captured chunk step
        self.compactions = 0
        self.captures, self.capture_s = 0, 0.0

    # -- the chunk program ------------------------------------------------------

    def _macro_step(self, split, commit: bool = True) -> None:
        """One macro step of JAX's ``_serve_chunk`` body over the loop's
        buffers. A slot whose admission token (the prefill's argmax) is its
        eos is killed first, as JAX kills it before the chunk's first step
        (a slot that generated its eos is inactive already, so killing at
        every step changes nothing else). Gated on ``any(active)``.
        ``commit=False`` (the capture's warm-up) computes the step and
        writes nothing."""
        kq = self.kq
        active = self.active_d & ~((self.last_tok == self.eos_d) & (self.eos_d >= 0))
        gate = active.any() if commit else torch.zeros((), dtype=torch.bool, device=active.device)
        t, a, _ = spec_macro_step(
            self.engine.params, self.last_tok, self.emitted_d, self.hist, self.hist_len, self.pos_d, self.k_pool,
            self.v_pool, self.cache_lens, self.dmask, self.cursor, cfg=self.cfg, draft_len=self.draft_len,
            attn_impl=self.attn_impl, tail_split=split, k_tail=self.k_tail, v_tail=self.v_tail, phys=self.phys,
            gate=gate)
        if not commit:
            return
        n_new = torch.minimum(a + 1, self.budgets_d - self.emitted_d)  # budget clamp
        n_new, eos_hit = _first_eos_clamp(t, n_new, self.eos_d, kq)
        n_new = torch.where(active, n_new, 0)
        update_rows(self.out, t, self.emitted_d, gate)
        update_rows(self.hist, t, self.hist_len, gate)
        pos_iota = torch.arange(self.s_pool, device=t.device)
        self.dmask.bitwise_or_((pos_iota[None, :] >= self.cursor) & (pos_iota[None, :] < self.cursor + n_new[:, None]))
        self.emitted_d.add_(n_new)
        self.active_d.copy_(active & ~eos_hit & (self.emitted_d < self.budgets_d))
        self.last_tok.copy_(torch.where(n_new > 0, t.gather(1, (n_new - 1).clamp(min=0)[:, None])[:, 0],
                                        self.last_tok))
        self.hist_len.add_(n_new)
        self.cursor.add_(kq * gate.to(torch.int64))

    def _graph(self, split) -> _ServeChunk:
        graph = self._graphs.get(split)
        if graph is None:
            with span("serve.capture"):
                if self.k_pool.device.type == "cuda":
                    torch.cuda.synchronize(self.k_pool.device)
                t0 = time.perf_counter()
                graph = self._graphs[split] = _ServeChunk(self, split)
                if self.k_pool.device.type == "cuda":
                    torch.cuda.synchronize(self.k_pool.device)
                self.captures += graph.graph is not None
                self.capture_s += time.perf_counter() - t0
        return graph

    # -- request lifecycle --------------------------------------------------

    def submit(self, request: ServeRequest) -> int:
        if request.max_new_tokens > self.max_new_cap:
            raise ValueError(f"max_new_tokens {request.max_new_tokens} exceeds the loop's max_new_cap "
                             f"{self.max_new_cap}")
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be at least 1, got {request.max_new_tokens}")
        rid = self._next_id
        self._next_id += 1
        with span("serve.submit", rid):
            self._queue.append((rid, request, time.perf_counter()))
        return rid

    def _admit(self, slot: int, rid: int, request: ServeRequest, submitted_at: float, started_at: float) -> None:
        eng, inp = self.engine, request.inputs
        result = eng.prefill(inp.input_embeds, inp.patch_type, inp.position_ids, patch_num=inp.patch_num,
                             image_token_start=inp.image_token_start, image_token_length=inp.image_token_length,
                             mode=self.prefill_mode)
        if result.pos_dims != self.pos_dims:
            raise ValueError("rope layout mismatch")
        # Compaction invariant: a prefix plus a full budget of committed rows
        # must fit below region_start, or compaction would spill live rows
        # into the scratch region the next chunk overwrites.
        max_prefix = max(c[2] for c in result.layer_caches)
        prefix_limit = self.region_start - self.max_new_cap
        if max_prefix > prefix_limit:
            raise ValueError(f"prefix {max_prefix} exceeds prefix capacity {prefix_limit} (= region_start "
                             f"{self.region_start} - max_new_cap {self.max_new_cap}); raise prefix_cap")
        if self.phys is not None:
            p = self.tail_layers
            tail_prefix = max(c[2] for c in result.layer_caches[p:])
            tail_limit = self.tail_rs - self.max_new_cap
            if tail_prefix > tail_limit:
                raise ValueError(f"layer>={p} prefix {tail_prefix} exceeds tail pool capacity {tail_limit} (= tail "
                                 f"region {self.tail_rs} - max_new_cap {self.max_new_cap}); raise tail_pool's "
                                 f"tail_prefix_cap or lower P")
        with span("serve.splice"):
            if self.phys is None:
                lens = _splice_slot(eng, result, self.k_pool, self.v_pool, slot)
            else:
                # The tail pool's rows [0, S_tail) are the prefix and dead
                # padding: the first S_tail rows of the uniform layout's column.
                lens = (_splice_slot(eng, dataclasses.replace(result, layer_caches=result.layer_caches[:p]),
                                     self.k_pool, self.v_pool, slot)
                        + _splice_slot(eng, dataclasses.replace(result, layer_caches=result.layer_caches[p:]),
                                       self.k_tail, self.v_tail, slot))
            self.cache_lens[:, slot] = torch.as_tensor(lens, dtype=torch.int64)
            self.dmask[slot] = False
            # Token 0 stays on the device (no read at admission): a request
            # whose token 0 is its eos is killed in the chunk's first step.
            tok0 = torch.argmax(result.logits)
            self.out[slot] = 0
            self.out[slot, 0] = tok0
            self.last_tok[slot] = tok0
            pids = (np.zeros((0,), np.int64) if request.prompt_ids is None
                    else np.asarray(request.prompt_ids, np.int64).reshape(-1))[-self.seed_cap:]
            seed = np.zeros((self.hist.shape[1],), np.int64)
            seed[: len(pids)] = pids
            self.hist[slot] = torch.from_numpy(seed).to(self.hist.device)
            self.hist[slot, len(pids)] = tok0
            self.hist_len[slot] = len(pids) + 1
        self.emitted[slot] = 1
        self.active[slot] = request.max_new_tokens > 1
        self.budgets[slot] = request.max_new_tokens
        self.eos_ids[slot] = -1 if request.eos_token_id is None else request.eos_token_id
        self.pos_bases[slot] = result.decode_pos_base
        self._admit_lens[slot] = [int(c[2]) for c in result.layer_caches]
        self._tail_split_stale = True
        self._slot_req[slot] = rid
        tel = result.telemetry
        now = time.perf_counter()
        self._admitted_at[slot] = now
        self._slot_result[slot] = ServeResult(
            request_id=rid, tokens=[], prefill_mode=result.mode, admitted_step=self._chunk_idx,
            queue_s=now - submitted_at, wait_s=started_at - submitted_at, admit_s=now - started_at,
            prompt_len=int(inp.input_embeds.shape[0]) if tel is None else tel.original_length,
            kept_len=result.valid_len if tel is None else tel.final_length,
            vision_token_reduction=0.0 if tel is None else tel.vision_token_reduction,
            events=[] if tel is None else [(e.layer, e.kind, int(e.tokens_removed)) for e in tel.events])

    def _retire(self, slot: int, emitted: int, out_row) -> None:
        rid = self._slot_req[slot]
        with span("serve.retire", rid):
            toks = [int(x) for x in out_row[:emitted]]
            eos = int(self.eos_ids[slot])
            if eos >= 0 and eos in toks:
                toks = toks[: toks.index(eos) + 1]
            res = self._slot_result[slot]
            res.tokens, res.serve_s = toks, time.perf_counter() - self._admitted_at[slot]
            self._results[rid] = res
            self._slot_req[slot] = self._slot_result[slot] = None
            self.active[slot] = False

    # -- scheduling ----------------------------------------------------------

    def _fill_slots(self) -> None:
        for slot in range(self.b):
            if self._slot_req[slot] is None and self._queue:
                with span("serve.admit", self._queue[0][0]):
                    started_at = time.perf_counter()
                    rid, req, submitted_at = self._queue.pop(0)
                    self._admit(slot, rid, req, submitted_at, started_at)
                    if not self.active[slot]:  # a single-token request retires at once
                        self._retire(slot, int(self.emitted[slot]), self.out[slot].tolist())

    def _compact(self) -> None:
        if self.phys is None:
            _compact_pools(self.k_pool, self.v_pool, self.cache_lens, self.dmask, self.region_start)
        else:
            # Each physical pool in its own coordinates: the decode rows
            # [region_start, S_pool) sit at [tail_rs, S_tail) in the tail.
            p = self.tail_layers
            dmask_tail = torch.zeros((self.b, self.s_tail), dtype=torch.bool, device=self.dmask.device)
            dmask_tail[:, self.tail_rs:] = self.dmask[:, self.region_start:]
            _compact_pools(self.k_tail, self.v_tail, self.cache_lens[p:], dmask_tail, self.tail_rs)
            _compact_pools(self.k_pool, self.v_pool, self.cache_lens[:p], self.dmask, self.region_start)
        self.cursor.fill_(self.region_start)
        self._cursor = self.region_start
        self.compactions += 1

    def step(self) -> bool:
        """Admit, one chunk of decode, retire. Returns whether work remains.
        Runs under the engine's collectives scope (a sharded engine's)."""
        with collectives.use(getattr(self.engine, "scope", None)), span("serve.step"):
            return self._step()

    def _step(self) -> bool:
        self._fill_slots()
        if not self.active.any():
            return bool(self._queue)
        with span("serve.chunk", int(self.active.sum())):
            self._chunk()
        return bool(self._queue) or bool(self.active.any())

    def _chunk(self) -> None:
        """Compact if the chunk would not fit, upload the slot state, replay
        the chunk graph, read the state back and retire the finished slots."""
        if self._cursor + self.scratch > self.s_pool:  # the next chunk would not fit
            with span("serve.compact"):
                self._compact()
        if self.phys is not None:
            split = None  # the physical split is the narrow read
        else:
            if self._tail_split_stale:
                bounds = [[n + self.max_new_cap for n in lens] for lens in self._admit_lens]
                self._tail_split = best_tail_split_batch(bounds, self.s_pool, self.region_start,
                                                         self.engine.ff.bucket)
                self._tail_split_stale = False
            split = self._tail_split
        graph = self._graph(split)
        with span("serve.upload"):
            for buf, host in ((self.emitted_d, self.emitted), (self.active_d, self.active),
                              (self.budgets_d, self.budgets), (self.eos_d, self.eos_ids),
                              (self.pos_d, self.pos_bases)):
                buf.copy_(torch.from_numpy(host))
        with span("serve.replay"):
            graph._replay(self.chunk)
        self._chunk_idx += 1
        # One read a chunk: emitted, active and the cursor (and the out rows
        # of the slots that retire).
        with span("serve.read"):
            state = torch.cat([self.emitted_d, self.active_d.to(torch.int64), self.cursor[None]]).tolist()
        emitted, active_now, self._cursor = state[:self.b], state[self.b:2 * self.b], state[-1]
        out_host = None
        for slot in range(self.b):
            if self._slot_req[slot] is not None and self.active[slot] and not active_now[slot]:
                if out_host is None:
                    with span("serve.read"):
                        out_host = self.out.tolist()
                self._retire(slot, emitted[slot], out_host[slot])
        self.emitted = np.asarray(emitted, np.int64)
        self.active = np.asarray([bool(active_now[s]) and self._slot_req[s] is not None for s in range(self.b)])

    def run(self, max_chunks: int = 10_000) -> dict:
        """Drain the queue and every slot; returns {request_id: ServeResult}."""
        for _ in range(max_chunks):
            if not self.step():
                break
        if self._queue or self.active.any():
            raise RuntimeError(f"serving loop did not drain in {max_chunks} chunks")
        return self._results
