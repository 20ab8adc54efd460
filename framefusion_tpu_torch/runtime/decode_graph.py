"""The decode loop as one captured CUDA graph of the step.

Counterpart of ``framefusion_tpu.runtime.engine._decode_loop`` and
``_decode_chunk``: JAX runs the whole decode as one device program, a
``lax.scan`` whose sampled token feeds back on the device. Here one decode
step is captured as a ``torch.cuda.CUDAGraph`` and replayed once a token:

    embed the token -> ``qwen2.decode_step`` (device position and lengths)
    -> sample -> write the token to ``out[step + 1]`` -> ``step += 1``

Every tensor the step reads or writes is a static buffer the graph owns:
the pools, the per-layer lengths, ``pos_base`` and ``step``, the current
token, ``out`` (one slot a token, ``out[0]`` the token sampled from the
prefill's logits), the uniforms drawn before the loop (one a token, as JAX
splits one key a token) and the last step's logits. The graph unrolls the
layers, so each captured launch of kernels C and D keeps its constant layer
index, as JAX's scan body slices each layer's weights; kernel G reads its
length from ``lens`` when it runs, planned for the view's rows. A replay
reads nothing back to the host: ``generate_device`` replays n - 1 times
back to back and the host reads ``out`` once.

``BatchDecodeGraph`` does the same for the batched step
(``qwen2.decode_step_batch``, JAX's ``_decode_loop_batch``): B sequences'
pools side by side, B tokens a replay. Kernels C and D take the B rows
in one launch each and read each weight tile once for all of them, as the
TPU kernel does.

``SpecDecodeGraph`` and ``SpecBatchDecodeGraph`` capture one speculative
macro step (runtime/spec_decode.py: drafts, ``verify_step`` or
``verify_step_batch`` over K = draft_len + 1 rows, accept, commit), each
replay gated on the device by JAX's loop condition, so a replay after the
end changes nothing; runtime/serving.py captures its chunk's macro step on
the same base class (``StepGraph``).

On the card a step is warmed up on this device's capture stream, then
captured there; a capture that fails raises, and nothing falls back to
eager launches. On the CPU the same step body runs eagerly over the same
tensors (the path the CPU tests drive). A graph keeps the collectives
scope it was made under (a sharded engine's, ``parallel/collectives``) and
runs its step under it: NCCL's reduces are captured into the graph; under a
gloo group, whose reduces are staged through the host and cannot be
captured, the step runs eagerly on the card too and ``replays`` stays 0.
What a capture needs from the kernels' wrappers:

* the arrival counters of kernels C and G: each graph owns a zeroed
  buffer (``own_counters`` around its warm-up and capture), whose address
  its launches keep; the kernels leave it at zero, so graphs replayed at
  once on several streams never share counters;
* ``_build.stream_ptr`` reads torch's current stream, which
  ``torch.cuda.graph`` sets to the capture stream;
* the wrappers' workspaces (``torch.empty``) come from the graph's private
  memory pool while it is captured, and stay reserved for its replays.

One decode runs at a time on a graph: the engine marks a graph ``busy``
from the start of a decode to its end and captures another for a decode
that asks meanwhile. A replay calls no kernel wrapper, so the wrappers'
counts miss its launches: ``StepGraph.replays`` (also read as
``DecodeGraph.replays``) counts the replays of every graph and
``StepGraph.replayed`` the kernel launches they ran, by
kernel (each replay adds its graph's ``launches_per_step``, the launches
the wrappers recorded while it was captured).
"""

from __future__ import annotations

import gc
from collections import Counter

import numpy as np
import torch

from ..models import qwen2
from ..ops.kernels import captured_counts
from ..ops.kernels.decode_attention import MAX_COUNTERS, own_counters
from ..ops.sampling import SamplerConfig, sample_token
from ..parallel import collectives
from . import spec_decode

_STREAMS: dict = {}


def capture_stream(device) -> "torch.cuda.Stream":
    """The stream this process captures CUDA graphs on, one per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def capture_graph(body, device, warmup=None) -> "torch.cuda.CUDAGraph":
    """Run ``warmup()`` (``body()`` when None) eagerly on ``device``'s
    capture stream, then capture one call of ``body()`` there. The warm-up
    builds and loads the kernels, makes the stream's arrival counters and
    lets cuBLAS set up its workspace outside the capture."""
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        (warmup or body)()
    current.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    # Under a collectives scope the NCCL watchdog thread queries its events
    # while this thread captures: only this thread's calls are checked.
    mode = "global" if collectives.current() is None else "thread_local"
    # No garbage collection inside the capture: freeing an unreachable graph
    # there (its destructor is a CUDA call) invalidates the capture.
    collect = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode=mode):
            body()
    finally:
        if collect:
            gc.enable()
    return graph


def slots_for(max_new_tokens: int) -> int:
    """Token slots of a graph: the next power of two, at least 16, so that
    nearby ``max_new_tokens`` share one graph."""
    return max(16, 1 << (max_new_tokens - 1).bit_length())


class StepGraph:
    """A step over static buffers, captured once as a CUDA graph on the card
    and replayed; on the CPU the same ``_step`` runs eagerly. A subclass
    allocates its buffers, defines ``_step`` and calls ``_setup``.

    ``StepGraph.replays`` counts the replays of every graph since
    ``reset_counts`` and ``StepGraph.replayed`` the kernel launches they ran,
    by kernel: each replay adds its graph's ``launches_per_step``, the
    launches the wrappers recorded while it was captured (empty on the CPU).
    """

    replays = 0
    replayed: Counter = Counter()

    @classmethod
    def reset_counts(cls) -> None:
        StepGraph.replays = 0
        StepGraph.replayed = Counter()

    def _setup(self, dev, warmup=None) -> None:
        """Capture ``_step`` on the card (after ``warmup()``, ``_step()`` when
        None), with arrival counters of the graph's own."""
        self.busy = False  # a decode runs on the graph (set and cleared by its owner)
        self.graph = None
        self.launches_per_step: dict = {}
        self.scope = collectives.current()
        if dev.type != "cuda" or not collectives.capturable():
            return
        self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device=dev)
        before = captured_counts()
        with own_counters(self.counters):
            self.graph = capture_graph(self._step, dev, warmup)
        after = captured_counts()
        self.launches_per_step = {k: after[k] - before[k] for k in after if after[k] > before[k]}

    def _step(self) -> None:
        raise NotImplementedError

    def _replay(self, n: int) -> None:
        """``n`` steps: replays back to back on the card, eager on the CPU
        (and under a gloo group)."""
        with collectives.use(self.scope):
            for _ in range(n):
                if self.graph is not None:
                    self.graph.replay()
                    StepGraph.replays += 1
                    StepGraph.replayed.update(self.launches_per_step)
                else:
                    self._step()


class DecodeGraph(StepGraph):
    """One decode step over static buffers: captured on the card, eager on
    the CPU.

    Args:
        params, cfg: the decoder.
        s_pool: rows of the pools.
        attn_impl: ``qwen2.decode_step``'s ("ragged": kernel G).
        tail_split: ``(P, tail_s)`` or None, as ``decode_step`` takes it.
        sampler: the ``SamplerConfig`` of the step.
        n_slots: tokens ``out`` holds (the decode's first one included).
    """

    def __init__(self, params: dict, cfg, s_pool: int, *, attn_impl: str, tail_split, sampler: SamplerConfig,
                 n_slots: int):
        dev = params["embed"].device
        self.params, self.cfg = params, cfg
        self.attn_impl, self.tail_split, self.sampler, self.n_slots = attn_impl, tail_split, sampler, n_slots
        self.max_steps = n_slots - 1
        self._alloc(s_pool, dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = 0  # steps run since ``start`` (the host's count of ``step``)
        self._setup(dev)

    def _alloc(self, s_pool: int, dev) -> None:
        """The pools, the per-layer lengths (``lens``), the first position
        (``pos_base``), the current token, ``out``, the uniforms and the
        last step's logits."""
        cfg = self.cfg
        shape = (cfg.num_layers, s_pool, cfg.num_kv_heads, cfg.head_dim_)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.lens = torch.ones(cfg.num_layers, dtype=torch.int64, device=dev)  # a valid state to warm up on
        self.pos_base = torch.zeros((), dtype=torch.int64, device=dev)
        self.tok = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros(self.n_slots, dtype=torch.int64, device=dev)
        self.uniforms = torch.zeros(self.n_slots, dtype=torch.float32, device=dev)
        self.logits = torch.zeros(cfg.vocab_size, dtype=torch.float32, device=dev)

    def _logits(self, te: torch.Tensor) -> torch.Tensor:
        """The decoder's step on the embedded token: its logits; the pools
        and ``lens`` advance in place."""
        logits, _, _, lens = qwen2.decode_step(self.params, te, self.pos_base + self.step, self.k_pool, self.v_pool,
                                               self.lens, self.cfg, attn_impl=self.attn_impl,
                                               tail_split=self.tail_split)
        self.lens.copy_(lens)
        return logits

    def _step(self) -> None:
        logits = self._logits(qwen2.embed(self.params, self.tok))
        self.logits.copy_(logits)
        slot = (self.step + 1).reshape(1)
        u = self.uniforms.index_select(0, slot)[0] if self.sampler.temperature else None
        tok = sample_token(logits, self.sampler, u=u)
        self.tok.copy_(tok)
        self.out.index_copy_(0, slot, tok[None])
        self.step.add_(1)

    def start(self, lens, pos_base, first_logits: torch.Tensor, uniforms=None) -> None:
        """Begin a decode over the pools (already filled): the lengths, the
        first rotary position, the prefill's logits (the first token is
        sampled from them here, with ``uniforms[0]``) and, for a sampled
        decode, one uniform a token."""
        self.lens.copy_(torch.as_tensor(lens, dtype=torch.int64))
        self.pos_base.copy_(torch.as_tensor(pos_base, dtype=torch.int64))
        self.step.zero_()
        self.out.zero_()
        self.steps = 0
        if uniforms is not None:
            self.uniforms[: uniforms.shape[0]].copy_(uniforms)
        tok = sample_token(first_logits, self.sampler, u=self.uniforms[0])
        self.tok.copy_(tok)
        self.out[0].copy_(tok)

    def run(self, n: int) -> None:
        """``n`` decode steps: ``n`` replays back to back on the card."""
        if self.steps + n > self.max_steps:
            raise ValueError(f"{self.steps} + {n} steps overflow the graph's {self.max_steps} steps")
        self._replay(n)
        self.steps += n


class BatchDecodeGraph(DecodeGraph):
    """The batched decode step (``qwen2.decode_step_batch``, the counterpart
    of JAX's ``_decode_loop_batch`` body) over static buffers, captured and
    replayed as ``DecodeGraph`` is:

        embed ``tok`` (B,) -> ``decode_step_batch`` (device ``step``,
        ``pos_base + step``) -> sample B rows -> ``out[step + 1, :]`` ->
        ``step += 1``

    The pools are (L, B, S_pool, Hk, hd) and ``lens`` the (L, B) prefix
    lengths, constant through the decode (the step masks the decode region
    ``[write_pos, write_pos + step)`` instead); ``pos_base`` is (B,), ``out``
    and the uniforms (n_slots, B), ``logits`` (B, V). ``write_pos``, the
    start of the common decode region, is fixed when the graph is made, as
    JAX makes it static.

    Args:
        batch: the rows B. write_pos: the decode region's first row.
        attn_impl: ``decode_step_batch``'s ("flash": kernels C and D).
        tail_split: ``(P, tail_s, region_start)`` or None.
        The others as ``DecodeGraph`` takes them.
    """

    def __init__(self, params: dict, cfg, s_pool: int, *, batch: int, write_pos: int, attn_impl: str, tail_split,
                 sampler: SamplerConfig, n_slots: int):
        self.batch, self.write_pos = batch, write_pos
        super().__init__(params, cfg, s_pool, attn_impl=attn_impl, tail_split=tail_split, sampler=sampler,
                         n_slots=n_slots)
        self.max_steps = min(n_slots - 1, s_pool - write_pos)

    def _alloc(self, s_pool: int, dev) -> None:
        cfg, b = self.cfg, self.batch
        shape = (cfg.num_layers, b, s_pool, cfg.num_kv_heads, cfg.head_dim_)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.lens = torch.zeros((cfg.num_layers, b), dtype=torch.int64, device=dev)
        self.pos_base = torch.zeros(b, dtype=torch.int64, device=dev)
        self.tok = torch.zeros(b, dtype=torch.int64, device=dev)
        self.out = torch.zeros((self.n_slots, b), dtype=torch.int64, device=dev)
        self.uniforms = torch.zeros((self.n_slots, b), dtype=torch.float32, device=dev)
        self.logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)

    def _logits(self, te: torch.Tensor) -> torch.Tensor:
        return qwen2.decode_step_batch(self.params, te, self.pos_base + self.step, self.k_pool, self.v_pool, self.lens,
                                       self.write_pos, self.step, self.cfg, attn_impl=self.attn_impl,
                                       tail_split=self.tail_split)[0]


class SpecDecodeGraph(StepGraph):
    """One speculative macro step (the body of JAX's ``spec_decode_loop``)
    over static buffers, captured and replayed:

        drafts from ``hist`` -> embed ``[last, drafts]`` (K rows) ->
        ``qwen2.verify_step`` (device lengths, positions ``pos_base +
        emitted - 1 + arange(K)``) -> argmax -> accept the longest matching
        prefix plus one -> ``out`` / ``hist`` rows, ``emitted``, ``lens``
        and the stats advance

    The buffers: the pools (L, S_pool, Hk, hd), ``lens`` (L,), ``pos_base``,
    ``emitted``, ``last``, ``out`` (slots + K), ``hist`` and ``hist_len``,
    ``max_new`` and the stats ``steps`` / ``drafted`` / ``accepted``. A
    replay is gated on ``emitted < max_new``, JAX's loop condition: after
    the end it commits nothing, counts nothing and writes no pool row
    (``qwen2._write_rows``), so a chunk of replays may run past the end.

    Args:
        s_pool: rows of the pools. draft_len: K - 1. hist_cap: the history's
            length. n_slots: the tokens ``out`` holds. The others as
            ``DecodeGraph`` takes them (``attn_impl`` is ``verify_step``'s).
    """

    def __init__(self, params: dict, cfg, s_pool: int, *, attn_impl: str, tail_split, draft_len: int,
                 hist_cap: int, n_slots: int):
        dev = params["embed"].device
        self.params, self.cfg, self.attn_impl, self.tail_split = params, cfg, attn_impl, tail_split
        self.draft_len, self.kq, self.n_slots = draft_len, draft_len + 1, n_slots
        self._alloc(s_pool, hist_cap, dev)
        self._setup(dev)

    def _alloc(self, s_pool: int, hist_cap: int, dev) -> None:
        cfg = self.cfg

        def scalar():
            return torch.zeros((), dtype=torch.int64, device=dev)

        shape = (cfg.num_layers, s_pool, cfg.num_kv_heads, cfg.head_dim_)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.lens = torch.zeros(cfg.num_layers, dtype=torch.int64, device=dev)
        self.pos_base, self.emitted, self.last, self.hist_len, self.max_new = (scalar() for _ in range(5))
        self.steps, self.drafted, self.accepted = scalar(), scalar(), scalar()
        self.out = torch.zeros(self.n_slots + self.kq, dtype=torch.int64, device=dev)
        self.hist = torch.zeros(hist_cap, dtype=torch.int64, device=dev)

    def _step(self) -> None:
        dev, kq = self.k_pool.device, self.kq
        active = self.emitted < self.max_new
        drafts, found = spec_decode.draft_lookup(self.hist, self.hist_len, self.draft_len)
        rows = torch.cat([self.last.reshape(1), drafts])
        pos = self.pos_base + (self.emitted - 1) + torch.arange(kq, device=dev)
        logits = qwen2.verify_step(self.params, qwen2.embed(self.params, rows), pos, self.k_pool, self.v_pool,
                                   self.lens, self.cfg, attn_impl=self.attn_impl, tail_split=self.tail_split,
                                   gate=active)[0]
        t = torch.argmax(logits, dim=-1)  # (K,)
        a = spec_decode.accepted_drafts(drafts, t)  # 0..draft_len drafts, then the bonus token t[a]
        n_new = torch.where(active, a + 1, 0)
        spec_decode.update_rows(self.out, t, self.emitted, active)
        spec_decode.update_rows(self.hist, t, self.hist_len, active)
        self.last.copy_(torch.where(active, t.index_select(0, a.reshape(1))[0], self.last))
        for buf in (self.emitted, self.hist_len, self.lens):
            buf.add_(n_new)
        self.steps.add_(active.to(torch.int64))
        self.drafted.add_(torch.where(active & found, self.draft_len, 0))
        self.accepted.add_(torch.where(active, a, 0))

    def start(self, lens, pos_base, first_logits: torch.Tensor, seeds, max_new: int) -> None:
        """Begin a decode over the filled pools: the lengths, the first rotary
        position(s), the prefill's logits (token 0 is their argmax), the
        history seeds (one id list a sequence) and ``max_new``."""
        dev = self.k_pool.device
        b = len(seeds)
        tok0 = torch.argmax(first_logits.reshape(b, -1), dim=-1)
        hist = np.zeros((b, self.hist.shape[-1]), np.int64)
        for i, s in enumerate(seeds):
            hist[i, : len(s)] = s
        hist = torch.from_numpy(hist).to(dev)
        hl = torch.tensor([len(s) for s in seeds], dtype=torch.int64, device=dev)
        hist.scatter_(1, hl[:, None], tok0[:, None])
        out = torch.zeros((b, self.out.shape[-1]), dtype=torch.int64, device=dev)
        out[:, 0] = tok0
        self.hist.copy_(hist.reshape(self.hist.shape))
        self.hist_len.copy_((hl + 1).reshape(self.hist_len.shape))
        self.out.copy_(out.reshape(self.out.shape))
        self.last.copy_(tok0.reshape(self.last.shape))
        self.lens.copy_(torch.as_tensor(lens, dtype=torch.int64))
        self.pos_base.copy_(torch.as_tensor(pos_base, dtype=torch.int64))
        self.emitted.fill_(1)
        self.max_new.fill_(max_new)
        for buf in (self.steps, self.drafted, self.accepted):
            buf.zero_()

    def run(self, n: int) -> None:
        """``n`` macro steps (gated)."""
        self._replay(n)


class SpecBatchDecodeGraph(SpecDecodeGraph):
    """The batched macro step (the body of JAX's ``spec_decode_loop_batch``:
    ``spec_decode.spec_macro_step`` over B sequences, every sequence's K rows
    written at the common offset ``write_pos + steps * K``) over static
    buffers: the pools (L, B, S_pool, Hk, hd), ``lens`` (L, B) (constant:
    the committed decode rows are marked in ``dmask`` (B, S_pool) instead),
    ``pos_base``, ``emitted``, ``last``, ``hist_len``, ``drafted`` and
    ``accepted`` (B,), ``out`` (B, slots + K), ``hist`` (B, hist_cap). A
    replay is gated on ``min(emitted) < max_new``, JAX's loop condition;
    within it a finished sequence commits nothing. ``write_pos`` is fixed
    when the graph is made, as JAX's pool geometry is."""

    def __init__(self, params: dict, cfg, s_pool: int, *, batch: int, write_pos: int, attn_impl: str, tail_split,
                 draft_len: int, hist_cap: int, n_slots: int):
        self.batch, self.write_pos = batch, write_pos
        super().__init__(params, cfg, s_pool, attn_impl=attn_impl, tail_split=tail_split, draft_len=draft_len,
                         hist_cap=hist_cap, n_slots=n_slots)

    def _alloc(self, s_pool: int, hist_cap: int, dev) -> None:
        cfg, b = self.cfg, self.batch

        def rows():
            return torch.zeros(b, dtype=torch.int64, device=dev)

        shape = (cfg.num_layers, b, s_pool, cfg.num_kv_heads, cfg.head_dim_)
        self.k_pool = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.lens = torch.zeros((cfg.num_layers, b), dtype=torch.int64, device=dev)
        self.dmask = torch.zeros((b, s_pool), dtype=torch.bool, device=dev)
        self.pos_base, self.emitted, self.last, self.hist_len = rows(), rows(), rows(), rows()
        self.drafted, self.accepted = rows(), rows()
        self.steps = torch.zeros((), dtype=torch.int64, device=dev)
        self.max_new = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((b, self.n_slots + self.kq), dtype=torch.int64, device=dev)
        self.hist = torch.zeros((b, hist_cap), dtype=torch.int64, device=dev)

    def _step(self) -> None:
        kq = self.kq
        active = self.emitted < self.max_new  # (B,)
        gate = active.any()  # min(emitted) < max_new
        base = self.write_pos + self.steps * kq
        t, a, found = spec_decode.spec_macro_step(
            self.params, self.last, self.emitted, self.hist, self.hist_len, self.pos_base, self.k_pool, self.v_pool,
            self.lens, self.dmask, base, cfg=self.cfg, draft_len=self.draft_len, attn_impl=self.attn_impl,
            tail_split=self.tail_split, gate=gate)
        n_new = torch.where(active, a + 1, 0)
        # A finished sequence rewrites its padding slots, as in JAX.
        spec_decode.update_rows(self.out, t, self.emitted, gate)
        spec_decode.update_rows(self.hist, t, self.hist_len, gate)
        pos_iota = torch.arange(self.dmask.shape[1], device=self.dmask.device)
        self.dmask.bitwise_or_((pos_iota[None, :] >= base) & (pos_iota[None, :] < base + n_new[:, None]))
        self.emitted.add_(n_new)
        self.hist_len.add_(n_new)
        self.last.copy_(torch.where(active, t.gather(1, a[:, None])[:, 0], self.last))
        self.steps.add_(gate.to(torch.int64))
        self.drafted.add_(torch.where(active & found, self.draft_len, 0))
        self.accepted.add_(torch.where(active, a, 0))

    def start(self, lens, pos_base, first_logits: torch.Tensor, seeds, max_new: int) -> None:
        super().start(lens, pos_base, first_logits, seeds, max_new)
        self.dmask.zero_()
