"""Sequence-sharded compressed prefill (port of
``framefusion_tpu.parallel.seq_shard``).

Each rank of a ``seq`` group owns a contiguous block of the hidden states'
rows and computes q / k / v for its rows; the causal and validity masks use
each row's global position, so every softmax row is the one-device row. K /
V reach the other ranks one of two ways, both walked blockwise with an
online softmax:

* gather (default): ``all_gather`` of K / V each layer;
* ring (``ring=True``): each rank keeps its own block and the blocks rotate
  around the group (``batch_isend_irecv``, n - 1 hops), each visit folded
  into the same online softmax. A capture layer keeps the gather, as JAX's
  does: the importance needs whole softmax rows.

The prune importance is each rank's sum over the capture rows it owns,
summed over the group. Between layers the decisions are the segmented
executor's own (``engine.SegmentedEventState``, ``segmented_merge`` and
``segmented_prune``), run on the gathered rows on every rank alike; the
MLP of an event layer then runs on each rank's block of the compacted rows.

JAX computes this attention with ``jnp.einsum`` (no Pallas kernel), so this
module is plain torch too: scores in fp32 from the q / k values, the
probabilities rounded to V's dtype before the P.V product, as JAX's
``preferred_element_type=float32`` einsums. The parameters are whole on
every rank (JAX's 1D ``seq`` mesh); a dense stack only (the MoE MLP's
capacity is a decision over all rows).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import FrameFusionConfig, LLMConfig
from ..core import PAD_TOKEN, TEXT_TOKEN, bucket_length
from ..models import qwen2
from ..ops.attention import NEG_INF
from ..runtime.engine import SegmentedEventState, segmented_merge, segmented_prune
from ..runtime.telemetry import PrefillTelemetry
from .collectives import Group


def make_seq_mesh(world=None, seq=None):
    """A ``(data, seq)`` DeviceMesh over the process group's ranks: ``seq``
    (all ranks by default) shard each prompt's rows, ``data`` replicas run
    prompts of their own. Its device type is ``sharding.mesh_device_type()``'s."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .sharding import mesh_device_type

    world = dist.get_world_size() if world is None else world
    seq = world if seq is None else seq
    if world % seq:
        raise ValueError(f"{world} ranks not divisible by seq={seq}")
    return init_device_mesh(mesh_device_type(), (world // seq, seq), mesh_dim_names=("data", "seq"))


def _block(n: int, candidates) -> int:
    return next(b for b in candidates if n % b == 0)


def _fold(state, qg, q_pos, k_blk, v_blk, k_pos, valid_len: int, scale: float):
    """Fold one K / V block (T, Hk, hd) at global positions ``k_pos`` into
    the online softmax ``state`` = (m, l, acc) of the queries ``qg`` (Hk, G,
    S_local, hd) fp32 at ``q_pos``."""
    m, l, acc = state
    s = torch.einsum("hgsd,thd->hgst", qg, k_blk.to(torch.float32)) * scale
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < valid_len)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("hgst,thd->hgsd", p.to(v_blk.dtype).to(torch.float32), v_blk.to(torch.float32))
    return m_new, l, acc * alpha + pv


def sharded_layer(lp: dict, h_l, cos_l, sin_l, valid_len: int, cfg: LLMConfig, group: Group, *, do_mlp: bool,
                  capture_num: int = 0, ring: bool = False):
    """One decoder layer over this rank's row block ``h_l`` (S / n, D) of a
    sequence-sharded state (JAX's ``_sharded_layer_fn``). Returns (the
    block's output, the (S,) importance of the last ``capture_num`` live
    rows or None)."""
    if ring and capture_num:
        raise ValueError("ring mode has no importance capture")
    n, s_local = group.size, h_l.shape[0]
    s_full, q_off = s_local * n, group.rank * s_local
    hd, hk = cfg.head_dim_, cfg.num_kv_heads
    g = cfg.num_heads // hk
    scale = 1.0 / math.sqrt(hd)
    dev = h_l.device

    x = qwen2.rmsnorm(h_l, lp["ln1"], cfg.rms_norm_eps)
    q, k, v = qwen2._project_qkv(lp, x, cfg)
    q, k = qwen2.apply_rope(q, k, cos_l, sin_l)
    qg = q.reshape(s_local, hk, g, hd).permute(1, 2, 0, 3).to(torch.float32)  # (Hk, G, S/n, hd)
    q_pos = q_off + torch.arange(s_local, device=dev)
    state = (torch.full((hk, g, s_local, 1), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((hk, g, s_local, 1), dtype=torch.float32, device=dev),
             torch.zeros((hk, g, s_local, hd), dtype=torch.float32, device=dev))
    k_all = None
    if ring:
        # After t hops this rank holds the block that started on rank (rank - t) mod n.
        sub = _block(s_local, (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1))
        kc, vc = k, v
        for t in range(n):
            blk_off = ((group.rank - t) % n) * s_local
            for j in range(0, s_local, sub):
                state = _fold(state, qg, q_pos, kc[j:j + sub], vc[j:j + sub],
                              blk_off + j + torch.arange(sub, device=dev), valid_len, scale)
            if t < n - 1:
                kc, vc = group.rotate([kc, vc])
    else:
        k_all, v_all = group.all_gather(k, dim=0), group.all_gather(v, dim=0)  # (S, Hk, hd)
        block_k = _block(s_full, (1024, 512, 256, 128, 64, 32, 16, 8))
        for j in range(0, s_full, block_k):
            state = _fold(state, qg, q_pos, k_all[j:j + block_k], v_all[j:j + block_k],
                          j + torch.arange(block_k, device=dev), valid_len, scale)
    _, l, acc = state
    out = (acc / torch.clamp(l, min=1e-30)).permute(2, 0, 1, 3).reshape(s_local, -1).to(h_l.dtype)
    h_mid = h_l + qwen2.mm(out, lp["wo"])

    importance = None
    if capture_num:
        # Rows [valid - num, valid) of the compacted state: each rank scores
        # the rows it owns against every key, and the group's sum assembles
        # last_rows_importance.
        row_pos = valid_len - capture_num + torch.arange(capture_num, device=dev)
        owned = (row_pos >= q_off) & (row_pos < q_off + s_local)
        q_rows = q[(row_pos - q_off).clamp(0, s_local - 1)].to(torch.float32)  # (num, Hq, hd)
        q_rows = q_rows.reshape(capture_num, hk, g, hd).permute(1, 2, 0, 3)
        s_r = torch.einsum("hgnd,thd->hgnt", q_rows, k_all.to(torch.float32)) * scale
        kmask = torch.arange(s_full, device=dev)[None, :] <= row_pos[:, None]
        s_r = torch.where(kmask[None, None], s_r, torch.full_like(s_r, NEG_INF))
        probs = torch.softmax(s_r, dim=-1).mean(dim=(0, 1))  # (num, S)
        partial = torch.where(owned[:, None], probs, torch.zeros_like(probs)).sum(dim=0)
        importance = group.all_reduce(partial) / capture_num
    h_out = qwen2.layer_mlp(lp, h_mid, cfg) if do_mlp else h_mid
    return h_out, importance


def seq_sharded_prefill(params: dict, cfg: LLMConfig, ff: FrameFusionConfig, input_embeds, patch_type,
                        position_ids, patch_num: int, image_token_start: int, image_token_length: int, mesh,
                        ring: bool = False):
    """Compressed prefill with each layer's rows sharded over ``mesh``'s
    ``seq`` axis, the segmented executor's decisions on every rank
    (module docstring). ``ring=True`` rotates K / V instead of gathering it
    on every layer but the capture layer. Returns (last live row's fp32
    logits (V,), telemetry, valid length), as JAX's."""
    if cfg.is_moe:
        raise ValueError("the sequence-sharded prefill runs dense stacks (a MoE MLP's capacity spans all rows)")
    group = Group(mesh.get_group("seq"))
    n, rank = group.size, group.rank
    if ff.bucket % n:
        raise ValueError(f"bucket {ff.bucket} must split evenly over the {n} ranks of the seq axis")
    dev = params["embed"].device
    orig_len = int(input_embeds.shape[0])
    pad = bucket_length(orig_len, ff.bucket) - orig_len
    h = torch.nn.functional.pad(torch.as_tensor(input_embeds).to(device=dev, dtype=cfg.dtype), (0, 0, 0, pad))
    pt = torch.nn.functional.pad(torch.as_tensor(np.asarray(patch_type), device=dev).to(torch.int64), (0, pad),
                                 value=PAD_TOKEN)
    pos = torch.nn.functional.pad(qwen2.pos_tokens(position_ids, dev), (0, 0, 0, pad))

    def block(t):
        rows = t.shape[0] // n
        return t[rank * rows:(rank + 1) * rows]

    telemetry = PrefillTelemetry(original_length=orig_len, image_token_length=image_token_length)
    state = SegmentedEventState(ff)
    valid, frame_tok = orig_len, int(np.sum(np.asarray(patch_type) != TEXT_TOKEN))
    # The layer-0 pre-attention merge on the whole (replicated) prompt.
    h, pt, pos, valid, event = segmented_merge(state, h, pt, pos, valid, frame_tok, -1, patch_num,
                                               always_compact=False)
    telemetry.events.append(event)
    frame_tok -= event.tokens_removed
    h_l = block(h)
    del h

    layer = 0
    while layer < cfg.num_layers and not state.done:
        lp = qwen2.layer_slice(params["layers"], layer)
        capture = ff.num_importance_queries if (state.finish_merging and not state.finish_pruning) else 0
        cos, sin = qwen2.token_cos_sin(pos, cfg)
        h_mid, importance = sharded_layer(lp, h_l, block(cos), block(sin), valid, cfg, group, do_mlp=False,
                                          capture_num=capture, ring=ring and not capture)
        h_full = group.all_gather(h_mid, dim=0)
        if not state.finish_merging:
            h_full, pt, pos, valid, event = segmented_merge(state, h_full, pt, pos, valid, frame_tok, layer,
                                                            patch_num, always_compact=True)
            frame_tok -= event.tokens_removed
        else:
            h_full, pt, pos, valid, event = segmented_prune(state, h_full, pt, pos, importance, valid, layer,
                                                            orig_len=orig_len, image_start=image_token_start,
                                                            image_len=image_token_length)
        telemetry.events.append(event)
        h_l = qwen2.layer_mlp(lp, block(h_full), cfg)
        del h_full
        layer += 1

    # The tail: the remaining layers at the compacted bucket, still sharded.
    cos, sin = qwen2.token_cos_sin(pos, cfg)
    cos_l, sin_l = block(cos), block(sin)
    for l in range(layer, cfg.num_layers):
        h_l, _ = sharded_layer(qwen2.layer_slice(params["layers"], l), h_l, cos_l, sin_l, valid, cfg, group,
                               do_mlp=True, ring=ring)

    # The last live row, from the rank that owns it.
    s_local = h_l.shape[0]
    owner, row = divmod(valid - 1, s_local)
    last = h_l[row].clone() if owner == rank else torch.zeros_like(h_l[0])
    last = group.all_reduce(last)
    logits = qwen2.final_logits(params, last[None], cfg)[0]
    telemetry.sparsity_list = list(state.sparsity)
    telemetry.final_length = valid
    telemetry.final_image_tokens = image_token_length - (orig_len - valid)
    return logits, telemetry, valid
