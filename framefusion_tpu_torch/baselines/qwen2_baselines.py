"""The paper's comparison baselines: FastV, StreamingLLM, fixed-schedule
prefill merging, merge->FastV and FastV->merge.

Port of ``framefusion_tpu.baselines.qwen2_baselines`` (the reference's
``replace_Qwen2_forward(model, mode=...)`` surface). Unlike FrameFusion's
data-dependent merge counts, every baseline's counts follow from the config
and the prompt's shape: FastV keeps ``round(L * (1 - r))`` image tokens at
layer ``k``, the fixed schedule removes ``int(s_l * frame_l)`` tokens at
layer ``l``, StreamingLLM's sink and window are constants. So the host knows
every event, cache length and bucket before the prefill runs, and nothing
is read back from the device during it.

Attention goes through the engine's ``attn_impl``: with ``"flash"`` the
causal layers use kernels A + B and StreamingLLM uses kernel F
(``ops/kernels/sink_prefill``); with ``"einsum"`` the plain versions
(``sink_attn_fwd_plain`` for StreamingLLM).

One deliberate difference from the JAX package: StreamingLLM's first-token
logits come from the last LIVE row (``orig_len - 1``), where the JAX program
takes the last row of the bucket-padded sequence, a pad row whenever the
prompt length is not a multiple of the bucket.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..config import FrameFusionConfig, LLMConfig
from ..core import (
    apply_merge,
    apply_merge_weighted,
    bucket_length,
    compact_tokens,
    descending_rank,
    mark_topk,
    order_by_patch,
    similarity_by_patch,
)
from ..models import qwen2
from ..ops.attention import NEG_INF
from ..ops.kernels.sink_prefill import sink_attn_fwd_plain, sink_flash_attention
from ..ops.rope import apply_rope
from ..ops.sampling import SamplerConfig
from ..runtime.engine import CompressionEngine, PrefillResult
from ..runtime.telemetry import CompressionEvent, PrefillTelemetry

MODES = ("fastv", "streamingllm", "prefill_merge", "merge_then_fastv", "fastv_then_merge")


def compute_density_overhead(sparsity_list) -> tuple:
    """(normalised cost, remaining density) of a fixed per-layer sparsity
    schedule: the reference's schedule-inspection helper, used when
    configuring prefill_merge."""
    cost = 0.0
    remaining_density = 1.0
    for s in sparsity_list:
        remaining_density *= 1.0 - s
        cost += remaining_density
    return cost / len(sparsity_list), remaining_density


def _ninf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, float("-inf"))


# ---------------------------------------------------------------------------
# FastV: at layer k, prune image tokens by the last row's head-averaged
# attention from layer k-1, keeping the top round(L * (1 - r)).


def _fastv_forward(params, h, pos, *, cfg: LLMConfig, attn_impl: str, fastv_k: int, img_start: int,
                   img_len: int, keep_img: int, new_len: int, valid0: int):
    """Returns (logits, k_pre, v_pre, k_post, v_post): the (L, ...) caches of
    the full-length layers < k and of the compacted layers >= k."""
    s = h.shape[0]
    cos, sin = qwen2.positions_cos_sin(pos, cfg)
    # Layers 0..k-2 dense; layer k-1 also captures the last live row's
    # importance (kernels A + B with "flash").
    h, k_pre, v_pre = qwen2.run_layers(params, h, cos, sin, cfg, stop_layer=fastv_k - 1, attn_impl=attn_impl)
    lp = qwen2.layer_slice(params["layers"], fastv_k - 1)
    h, kk, vv, importance = qwen2.layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl, capture_num=1,
                                                  valid_len=valid0)
    h = qwen2.layer_mlp(lp, h, cfg)
    k_pre[fastv_k - 1] = kk
    v_pre[fastv_k - 1] = vv

    # Static top-k over the image window; the stable compaction keeps the
    # survivors in their original order.
    idx = torch.arange(s, device=h.device)
    in_window = (idx >= img_start) & (idx < img_start + img_len)
    score = torch.where(in_window, importance, _ninf_like(importance))
    keep = (~in_window & (idx < valid0)) | (descending_rank(score) < keep_img)
    new_valid = valid0 - img_len + keep_img
    out, _ = compact_tokens(keep, new_len, new_valid, {"h": h, "pos": pos})

    cos2, sin2 = qwen2.positions_cos_sin(out["pos"], cfg)
    h2, k_post, v_post = qwen2.run_layers(params, out["h"], cos2, sin2, cfg, start_layer=fastv_k,
                                          attn_impl=attn_impl)
    logits = qwen2.final_logits(params, h2[new_valid - 1 : new_valid], cfg)[0]
    return logits, k_pre, v_pre, k_post, v_post


# ---------------------------------------------------------------------------
# StreamingLLM: prefill attention restricted to ``init_num`` sink tokens plus
# a trailing window of ``length_rate * S - init_num``; decode over the whole
# cache (or the windowed sink-cache decode below).


def _streamingllm_forward(params, h, pos, *, cfg: LLMConfig, attn_impl: str, init_num: int, window: int,
                          last_row: int):
    """Returns (logits of row ``last_row``, k_all, v_all (L, S, Hk, hd))."""
    s = h.shape[0]
    # Kernel F through the JAX entry point (its clamps included), or F's plain version.
    attend = sink_flash_attention if attn_impl == "flash" else sink_attn_fwd_plain
    cos, sin = qwen2.positions_cos_sin(pos, cfg)
    k_all = torch.empty((cfg.num_layers, s, cfg.num_kv_heads, cfg.head_dim_), dtype=cfg.dtype, device=h.device)
    v_all = torch.empty_like(k_all)
    for l in range(cfg.num_layers):
        lp = qwen2.layer_slice(params["layers"], l)
        x = qwen2.rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
        q, k, v = qwen2._project_qkv(lp, x, cfg)
        q, k = apply_rope(q, k, cos, sin)
        attn = attend(q, k, v, init_num, window)
        h = h + qwen2.mm(attn.reshape(s, -1), lp["wo"])
        h = qwen2.layer_mlp(lp, h, cfg)
        k_all[l] = k
        v_all[l] = v
    return qwen2.final_logits(params, h[last_row : last_row + 1], cfg)[0], k_all, v_all


# ---------------------------------------------------------------------------
# Fixed-schedule prefill merging: before each layer's attention, merge the
# top int(sparsity_l * frame_tokens_l) most similar adjacent-frame pairs
# (FrameFusion's merge core with fixed counts). The weighted variant carries
# token mass for merge->FastV.


def _merging_segment(params, h, pos, patch_type, weights, live, k_seg, *, cfg: LLMConfig, attn_impl: str,
                     patch_num: int, weighted: bool, fastv_k: int, keep_img: int, valid0: int,
                     img_start: int, img_len: int, start_layer: int):
    """Layers [start_layer, start_layer + len(k_seg)) at the current bucket,
    mask-only: merged and pruned tokens die in ``live``, which every
    attention takes as its key-valid vector (kernel A with "flash").
    ``fastv_k`` is the absolute layer of the FastV prune (-1: none in this
    segment); its importance is captured on that layer only.

    Returns (h, live, weights, [(k, v, live-at-attention) per layer])."""
    cos, sin = qwen2.positions_cos_sin(pos, cfg)
    caches = []
    for i, k_l in enumerate(k_seg):
        l = start_layer + i
        if k_l:
            order, n_img = order_by_patch(patch_type, live, patch_num)
            sim = similarity_by_patch(h, patch_type, order, n_img)
            marked = mark_topk(sim, k_l)
            if weighted:
                h, weights, keep = apply_merge_weighted(h, weights, marked, order)
            else:
                h, keep = apply_merge(h, marked, order)
            live = live & keep
        elif weighted:
            # The JAX program merges with zero marks too: for the weighted
            # merge that is (h * w) / w in fp32, not always h exactly.
            no_marks = torch.zeros_like(live)
            h, weights, _ = apply_merge_weighted(h, weights, no_marks, torch.arange(h.shape[0], device=h.device))

        lp = qwen2.layer_slice(params["layers"], l)
        prune = l == fastv_k
        h, k, v, importance = qwen2.layer_attention(lp, h, cos, sin, cfg, attn_impl=attn_impl,
                                                    capture_num=1 if prune else 0, key_valid=live)
        caches.append((k, v, live))
        if prune:
            live_rank = torch.cumsum(live.to(torch.int64), dim=0) - 1
            cur_img = img_len - (valid0 - live.sum())
            in_window = live & (live_rank >= img_start) & (live_rank < img_start + cur_img)
            score = torch.where(in_window, importance, _ninf_like(importance))
            live = (live & ~in_window) | (in_window & (descending_rank(score) < keep_img))
        h = qwen2.layer_mlp(lp, h, cfg)
    return h, live, weights, caches


# ---------------------------------------------------------------------------
# SinkCache-style decode (the Qwen2-VL StreamingLLM variant).


def _sink_attend(q, k_cache, v_cache, length: int, window_length: int, num_sink_tokens: int):
    """One token's attention over the first ``num_sink_tokens`` cache entries
    and the trailing ``window_length - num_sink_tokens``: fp32 scores, masked
    softmax. q: (Hq, D); k_cache, v_cache: (S_pad, Hk, D); ``length`` valid
    entries, the current token included."""
    s_pad, hk, d = k_cache.shape
    hq = q.shape[0]
    qf = q.reshape(hk, hq // hk, d).to(torch.float32)
    kf = k_cache.permute(1, 0, 2).to(torch.float32)
    vf = v_cache.permute(1, 0, 2).to(torch.float32)
    scores = torch.einsum("hgd,hkd->hgk", qf, kf) / math.sqrt(d)
    idx = torch.arange(s_pad, device=q.device)
    local_start = length - (window_length - num_sink_tokens)
    mask = (idx < length) & ((idx < num_sink_tokens) | (idx >= local_start))
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hgk,hkd->hgd", probs, vf).reshape(hq, d).to(q.dtype)


def _sink_cache_decode_loop(params, first_logits, k_pool, v_pool, cache_lens, pos_base: int, *,
                            cfg: LLMConfig, n_steps: int, window_length: int, num_sink_tokens: int):
    """Greedy decode in which each step attends only the ``num_sink_tokens``
    first cache entries and the trailing ``window_length - num_sink_tokens``
    (the reference swaps in ``SinkCache(window_length, num_sink_tokens)``).
    The cache is kept whole; the eviction is the attention mask, which is
    what decides the outputs. The pools are updated in place. Returns the
    (n_steps + 1,) token ids on the device and the logits that chose the
    last of them."""
    logits = first_logits
    tok = torch.argmax(logits)
    toks = [tok]
    lens = [int(n) for n in cache_lens]
    for step in range(n_steps):
        cos, sin = qwen2.positions_cos_sin(torch.tensor([pos_base + step], device=first_logits.device), cfg)
        h = qwen2.embed(params, tok)[None, :]
        for l in range(cfg.num_layers):
            lp = qwen2.layer_slice(params["layers"], l)
            x = qwen2.rmsnorm(h, lp["ln1"], cfg.rms_norm_eps)
            q, k, v = qwen2._project_qkv(lp, x, cfg)
            q, k = apply_rope(q, k, cos, sin)
            k_pool[l, lens[l]] = k[0].to(k_pool.dtype)
            v_pool[l, lens[l]] = v[0].to(v_pool.dtype)
            attn = _sink_attend(q[0], k_pool[l], v_pool[l], lens[l] + 1, window_length, num_sink_tokens)
            h = h + qwen2.mm(attn.reshape(1, -1), lp["wo"])
            h = qwen2.layer_mlp(lp, h, cfg)
        logits = qwen2.final_logits(params, h, cfg)[0]
        tok = torch.argmax(logits)
        toks.append(tok)
        lens = [n + 1 for n in lens]
    return torch.stack(toks), logits


class BaselineEngine(CompressionEngine):
    """Prefill executor for one baseline method; decode is inherited, except
    StreamingLLM's ``sink_cache_decode`` variant.

    Two buckets, as in the JAX package: ``bucket`` (the constructor
    argument) sizes FastV's compaction; ``ff.bucket`` (``FrameFusionConfig``'s
    default) sizes the padded prompt, the merging family's segments and the
    decode pool.
    """

    def __init__(self, params, cfg, mode: str, kwargs: dict, *, attn_impl: str = "flash", bucket: int = 128):
        super().__init__(params, cfg, FrameFusionConfig(), attn_impl=attn_impl)
        self.mode = mode
        self.kwargs = kwargs
        self.bucket = bucket

    def generate(self, result: PrefillResult, max_new_tokens: int, eos_token_id=None,
                 sampler: Optional[SamplerConfig] = None, generator=None):
        if not (self.mode == "streamingllm" and self.kwargs.get("sink_cache_decode")):
            return super().generate(result, max_new_tokens, eos_token_id=eos_token_id, sampler=sampler,
                                    generator=generator)
        if sampler is not None and sampler.temperature:
            raise NotImplementedError("sink_cache_decode decodes greedily only")
        out, _ = self.sink_cache_decode(result, max_new_tokens)
        if eos_token_id is not None and eos_token_id in out:
            out = out[: out.index(eos_token_id) + 1]
        return out

    def sink_cache_decode(self, result: PrefillResult, max_new_tokens: int):
        """StreamingLLM's SinkCache greedy decode: (``max_new_tokens`` token
        ids, the logits that chose the last one)."""
        window = self.kwargs.get("window_length", int(self.kwargs.get("length_rate", 0.3) * result.valid_len))
        sinks = self.kwargs.get("num_sink_tokens", self.kwargs.get("init_num", 8))
        k_pool, v_pool, lens = self.make_decode_state(result, max_new_tokens)
        toks, logits = _sink_cache_decode_loop(self.params, result.logits, k_pool, v_pool, lens,
                                               result.decode_pos_base, cfg=self.cfg, n_steps=max_new_tokens - 1,
                                               window_length=window, num_sink_tokens=sinks)
        return [int(t) for t in toks.tolist()], logits

    def prefill(self, input_embeds, patch_type, position_ids, patch_num: int, image_token_start: int,
                image_token_length: int, mode=None) -> PrefillResult:
        """Run this engine's baseline (``mode`` is the caller's executor
        choice for FrameFusion and is ignored here)."""
        if self.mode not in MODES:
            raise NotImplementedError(f"Mode {self.mode} is not implemented yet.")
        cfg = self.cfg
        h, pt, pos, orig_len = self._prep_inputs(input_embeds, patch_type, position_ids)
        telemetry = PrefillTelemetry(original_length=orig_len, image_token_length=image_token_length)

        if self.mode == "fastv":
            fastv_k = self.kwargs.get("fastv_k", 3)
            fastv_r = self.kwargs.get("fastv_r", 0.5)
            keep_img = round(image_token_length * (1 - fastv_r))
            new_valid = orig_len - image_token_length + keep_img
            logits, k_pre, v_pre, k_post, v_post = _fastv_forward(
                self.params, h, pos, cfg=cfg, attn_impl=self.attn_impl, fastv_k=fastv_k,
                img_start=image_token_start, img_len=image_token_length, keep_img=keep_img,
                new_len=bucket_length(new_valid, self.bucket), valid0=orig_len)
            caches = [(k_pre[l], v_pre[l], orig_len) if l < fastv_k else (k_post[l], v_post[l], new_valid)
                      for l in range(cfg.num_layers)]
            telemetry.events.append(CompressionEvent(layer=fastv_k, kind="fastv_prune",
                                                     tokens_removed=image_token_length - keep_img,
                                                     tokens_after=new_valid))
            final_valid = new_valid

        elif self.mode == "streamingllm":
            init_num = self.kwargs.get("init_num", 8)
            window = int(self.kwargs.get("length_rate", 0.3) * orig_len) - init_num
            logits, k_all, v_all = _streamingllm_forward(
                self.params, h, pos, cfg=cfg, attn_impl=self.attn_impl, init_num=init_num, window=window,
                last_row=orig_len - 1)
            caches = [(k_all[l], v_all[l], orig_len) for l in range(cfg.num_layers)]
            telemetry.events.append(CompressionEvent(layer=-1, kind="streaming_sink", tokens_removed=0,
                                                     tokens_after=orig_len))
            final_valid = orig_len

        else:
            logits, caches, final_valid = self._run_merging_family(
                h, pt, pos, orig_len, patch_num, image_token_start, image_token_length, telemetry)

        telemetry.final_length = final_valid
        telemetry.final_image_tokens = image_token_length - (orig_len - final_valid)
        return PrefillResult(logits=logits, layer_caches=caches, valid_len=final_valid,
                             decode_pos_base=caches[0][2], telemetry=telemetry, mode=self.mode)

    def _merging_schedule(self, orig_len: int, img_len: int, telemetry):
        """The static trajectory: per-layer merge counts, the live count at
        the end of each layer, the FastV layer and keep count, and the
        method's merge options. Appends the events to ``telemetry``."""
        n_layers = self.cfg.num_layers
        if self.mode == "prefill_merge":
            sparsity = self.kwargs.get("sparsity", [0.0] * n_layers)
            weighted, fastv_k, fastv_r = False, -1, 0.0
        elif self.mode == "merge_then_fastv":
            sparsity = self.kwargs.get("sparsity", [0.1] * n_layers)
            weighted = True
            fastv_k = self.kwargs.get("fastv_k", 3)
            fastv_r = self.kwargs.get("fastv_r", 0.5)
        else:  # fastv_then_merge: no merging before k; one merge right after
            fastv_k = self.kwargs.get("fastv_k", 2)
            fastv_r = self.kwargs.get("fastv_r", 0.75)
            merging_sparsity = self.kwargs.get("merging_sparsity", 0.3)
            sparsity = [0.0] * n_layers
            weighted = False

        k_list, len_end_of_layer = [], []
        remaining, cur_total, keep_img = img_len, orig_len, -1
        for l in range(n_layers):
            if self.mode == "fastv_then_merge":
                k_l = int(merging_sparsity * remaining) if l == fastv_k + 1 else 0
            else:
                k_l = int(sparsity[l] * remaining)
            k_list.append(k_l)
            remaining -= k_l
            cur_total -= k_l
            if k_l:
                telemetry.events.append(CompressionEvent(layer=l, kind="merge_fixed", tokens_removed=k_l,
                                                         tokens_after=cur_total))
            if l == fastv_k:
                keep_img = round(remaining * (1 - fastv_r))
                removed = remaining - keep_img
                remaining = keep_img
                cur_total -= removed
                telemetry.events.append(CompressionEvent(layer=l, kind="fastv_prune", tokens_removed=removed,
                                                         tokens_after=cur_total))
            len_end_of_layer.append(cur_total)
        return k_list, len_end_of_layer, fastv_k, keep_img, weighted

    def _run_merging_family(self, h, pt, pos, orig_len, patch_num, img_start, img_len, telemetry):
        cfg = self.cfg
        k_list, len_end_of_layer, fastv_k, keep_img, weighted = self._merging_schedule(orig_len, img_len,
                                                                                       telemetry)

        # Segments end wherever the live count drops a bucket quantum (or
        # after pool_layers layers), so the layers after a big merge or the
        # prune run at the smaller bucket at once.
        s_cur = h.shape[0]
        bounds, cur_start, cur_bucket = [], 0, s_cur
        for l in range(cfg.num_layers):
            end_bucket = bucket_length(len_end_of_layer[l], self.ff.bucket)
            if end_bucket < cur_bucket or (l - cur_start + 1) >= self.pool_layers:
                bounds.append((cur_start, l + 1))
                cur_start, cur_bucket = l + 1, end_bucket
        if cur_start < cfg.num_layers:
            bounds.append((cur_start, cfg.num_layers))

        caches = []
        live = torch.arange(s_cur, device=h.device) < orig_len
        weights = torch.ones((s_cur,), dtype=torch.float32, device=h.device)
        n_entry = orig_len  # live count at segment entry (== the last live row + 1)
        for seg_start, seg_end in bounds:
            h, live, weights, seg_caches = _merging_segment(
                self.params, h, pos, pt, weights, live, k_list[seg_start:seg_end], cfg=cfg,
                attn_impl=self.attn_impl, patch_num=patch_num, weighted=weighted,
                fastv_k=fastv_k if seg_start <= fastv_k < seg_end else -1, keep_img=keep_img,
                valid0=orig_len, img_start=img_start, img_len=img_len, start_layer=seg_start)
            caches += self._pack_caches(seg_caches)
            if seg_end >= cfg.num_layers:
                break
            n_after = len_end_of_layer[seg_end - 1]
            new_bucket = bucket_length(n_after, self.ff.bucket)
            if new_bucket < s_cur:
                out, _ = compact_tokens(live, new_bucket, n_after,
                                        {"h": h, "pos": pos, "patch_type": pt, "weights": weights})
                h, pos, pt, weights = out["h"], out["pos"], out["patch_type"], out["weights"]
                s_cur = new_bucket
                live = torch.arange(s_cur, device=h.device) < n_after
                n_entry = n_after
        logits = qwen2.final_logits(self.params, h[n_entry - 1 : n_entry], cfg)[0]
        return logits, caches, len_end_of_layer[-1]


def replace_forward(model, mode: str = "fastv", **kwargs):
    """Baseline entry point mirroring the reference's
    ``replace_Qwen2_forward``: returns a copy of ``model`` whose engine runs
    the requested baseline (``FrameFusionModel.prefill``/``generate`` then
    go through it)."""
    from ..interface import FrameFusionModel

    if not isinstance(model, FrameFusionModel):
        raise TypeError(f"replace_forward expects a framefusion_tpu_torch FrameFusionModel, got {type(model)}")
    engine = BaselineEngine(model.params, model.cfg, mode, kwargs, attn_impl=model.attn_impl)
    return dataclasses.replace(model, ff=None, _engine=engine)


# The reference's per-family aliases: every family rides the same backbone
# here, so they are the same dispatcher.
replace_qwen2_forward = replace_forward
replace_minicpmv_forward = replace_forward
replace_nvila_forward = replace_forward
replace_qwenvl_forward = replace_forward
