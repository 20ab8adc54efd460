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
in one launch each, but read the weights once a row (the rows are their
grid.z), where the TPU kernel reads each weight tile once for all rows.

On the card a step is warmed up on this device's capture stream, then
captured there; a capture that fails raises, and nothing falls back to
eager launches. On the CPU the same step body runs eagerly over the same
tensors (the path the CPU tests drive). What a capture needs from the
kernels' wrappers:

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
counts miss its launches: ``DecodeGraph.replays`` counts the replays of
every graph and ``DecodeGraph.replayed`` the kernel launches they ran, by
kernel (each replay adds its graph's ``launches_per_step``, the launches
the wrappers recorded while it was captured).
"""

from __future__ import annotations

from collections import Counter

import torch

from ..models import qwen2
from ..ops.kernels import captured_counts
from ..ops.kernels.decode_attention import MAX_COUNTERS, own_counters
from ..ops.sampling import SamplerConfig, sample_token

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
    with torch.cuda.graph(graph, stream=stream):
        body()
    return graph


def slots_for(max_new_tokens: int) -> int:
    """Token slots of a graph: the next power of two, at least 16, so that
    nearby ``max_new_tokens`` share one graph."""
    return max(16, 1 << (max_new_tokens - 1).bit_length())


class DecodeGraph:
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

    replays = 0  # replays of every decode graph since ``reset_counts``
    replayed: Counter = Counter()  # the kernel launches those replays ran, by kernel

    @classmethod
    def reset_counts(cls) -> None:
        DecodeGraph.replays = 0
        DecodeGraph.replayed = Counter()

    def __init__(self, params: dict, cfg, s_pool: int, *, attn_impl: str, tail_split, sampler: SamplerConfig,
                 n_slots: int):
        dev = params["embed"].device
        self.params, self.cfg = params, cfg
        self.attn_impl, self.tail_split, self.sampler, self.n_slots = attn_impl, tail_split, sampler, n_slots
        self.max_steps = n_slots - 1
        self._alloc(s_pool, dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.steps = 0  # steps run since ``start`` (the host's count of ``step``)
        self.busy = False  # a decode runs on the graph (set and cleared by the engine)
        self.graph = None
        # Kernel launches one captured step holds, by kernel (counted by the
        # wrappers while capturing); empty on the CPU.
        self.launches_per_step: dict = {}
        if dev.type == "cuda":
            self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.int32, device=dev)
            self._capture()

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

    def _capture(self) -> None:
        before = captured_counts()
        with own_counters(self.counters):
            self.graph = capture_graph(self._step, self.k_pool.device)
        after = captured_counts()
        self.launches_per_step = {k: after[k] - before[k] for k in after if after[k] > before[k]}

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
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
                DecodeGraph.replays += 1
                DecodeGraph.replayed.update(self.launches_per_step)
            else:
                self._step()
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
