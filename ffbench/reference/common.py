"""The plain reference: preprocessing, weight rounding, the decoder with FrameFusion's merge and prune.

Plain PyTorch and NumPy, written from the published descriptions and frozen
here: it imports nothing of the program and takes nothing the program
made. Everything runs in fp32 with TF32 off (``precise``), one layer at a
time; attention runs in blocks of query rows, so a long prompt fits.

``Precision`` says how the weights are rounded before the fp32 arithmetic:
the reference itself uses the precisions the configuration states (the
tower in bf16 as drawn, the decoder's matrices through int8 weight-only
quantization); the control rounds each to the next precision down (pixels
to bf16, the tower's and projector's matrices to fp8 e4m3, the decoder's
matrices to int4), the step that would tempt a faster program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from .. import weights

IGNORE = -2.0  # the similarity of a position that no merge may take
ATTN_BLOCK = 1024  # query rows a block
SCHEDULE_LAYERS = 28  # FrameFusion's cost schedule counts 28 layers (the upstream constant)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    pixels: str  # "fp32" or "bf16"
    tower: str  # "bf16" (as drawn) or "fp8"
    decoder: str  # "int8" or "int4"


REFERENCE = Precision("reference", "fp32", "bf16", "int8")
CONTROL = Precision("control", "bf16", "fp8", "int4")


@contextlib.contextmanager
def precise():
    """fp32 matmuls without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


# ---------------------------------------------------------------------------
# Preprocessing: PIL's antialiased bicubic resize (a = -0.5), half-pixel
# centers, weights normalised per output pixel; then (x / 255 - mean) / std.


def _cubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 resize weights."""
    scale = n_in / n_out
    support_scale = max(scale, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    w = _cubic((np.arange(n_in, dtype=np.float64)[None, :] + 0.5 - centers[:, None]) / support_scale)
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)


def preprocess(frames: np.ndarray, size: int, mean, std, precision: Precision = REFERENCE) -> np.ndarray:
    """uint8 (T, H, W, 3) -> (T, size, size, 3) float32 model pixels."""
    _, h, w, _ = frames.shape
    wy, wx = resize_matrix(h, size), resize_matrix(w, size)
    x = np.einsum("oh,thwc->towc", wy, frames.astype(np.float64), optimize=True)
    x = np.einsum("pw,towc->topc", wx, x, optimize=True)
    x = ((x / 255.0 - np.asarray(mean)) / np.asarray(std)).astype(np.float32)
    if precision.pixels == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    return x


# ---------------------------------------------------------------------------
# Weight rounding: symmetric per output channel of a (..., K, O) matrix.


def int_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Weight-only integer quantization, dequantized to fp32: scale = max_K
    |w| / (2^(bits-1) - 1), round half to even, clip."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 with a per-output-channel scale onto its largest value (448), back to fp32."""
    wf = w.to(torch.float32)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 448.0, min=1e-12)
    return (wf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tower_matrix(w: torch.Tensor, precision: Precision) -> torch.Tensor:
    return fp8_weight(w) if precision.tower == "fp8" else w.to(torch.float32)


def decoder_matrix(w: torch.Tensor, precision: Precision) -> torch.Tensor:
    return int_weight(w, 8 if precision.decoder == "int8" else 4)


# ---------------------------------------------------------------------------
# Blocks


def layer_norm(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def rms_norm(x: torch.Tensor, w, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def bidir_attention(q, k, v) -> torch.Tensor:
    """(B, N, H, hd) softmax(q k^T / sqrt(hd)) v over all keys."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-rotation rotary embedding of (S, H, hd) at integer positions (S,),
    angles in float64."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = pos.to(torch.float64)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang).to(torch.float32)[:, None], torch.sin(ang).to(torch.float32)[:, None]
    rot = torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], dim=-1)
    return x * cos + rot * sin


def causal_attention(q, k, v, importance_row: int = -1):
    """Causal GQA attention over (S, H, hd), in query blocks. With
    ``importance_row`` >= 0 also returns that row's attention probabilities
    over the keys, averaged over the heads."""
    s, hq, hd = q.shape
    g = hq // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    importance = None
    key_pos = torch.arange(s, device=q.device)
    for b0 in range(0, s, ATTN_BLOCK):
        b1 = min(s, b0 + ATTN_BLOCK)
        scores = torch.einsum("qhd,khd->hqk", q[b0:b1], k[: b1]) / math.sqrt(hd)
        mask = key_pos[None, : b1] <= torch.arange(b0, b1, device=q.device)[:, None]
        probs = torch.softmax(scores.masked_fill(~mask[None], float("-inf")), dim=-1)
        out[b0:b1] = torch.einsum("hqk,khd->qhd", probs, v[: b1])
        if b0 <= importance_row < b1:
            importance = torch.zeros(s, device=q.device)
            importance[: b1] = probs[:, importance_row - b0].mean(dim=0)
    return out, importance


# ---------------------------------------------------------------------------
# FrameFusion (arXiv:2501.01986; its ``main.py``): before layer 0 and after
# each layer's attention, merge each image token into the same patch of the
# previous frame where their cosine similarity passes S_th, at most the
# share the cost schedule allows; once merging slows below r_min, prune the
# image tokens of least attention from the last prompt row; the FLOP budget
# ``cost`` decides each share. Tokens are removed from the sequence, as the
# upstream code shrinks its tensors.


def pruning_ratio(sparsity: list, cost: float, num_layers: int = SCHEDULE_LAYERS) -> tuple:
    """(share the next event must remove, infeasible) in float32 arithmetic."""
    f = np.float32
    density, spent = f(1.0), f(0.0)
    for s in sparsity:
        density = f(density * (f(1.0) - f(s)))
        spent = f(spent + density)
    remaining = f(f(num_layers) * f(cost) - spent)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = f(remaining / f(f(num_layers - len(sparsity)) * density))
    if remaining < 0:
        return 1.0, True
    if frac > 1:
        return 0.0, False
    return float(f(f(1.0) - frac)), False


@dataclasses.dataclass
class FFState:
    cost: float
    s_th: float
    r_min: float
    frame_tok: int
    orig_len: int
    image_start: int
    image_len: int
    sparsity: list = dataclasses.field(default_factory=list)
    merging_done: bool = False
    pruning_done: bool = False
    infeasible: bool = False
    events: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.merging_done and self.pruning_done


def merge_event(st: FFState, h: torch.Tensor, pt: torch.Tensor, n_prompt: int, layer: int):
    """One merge over the prompt's image tokens of ``h`` (rows past
    ``n_prompt`` are served tokens, never merged). Returns (h, keep)."""
    f = np.float32
    idx = torch.nonzero(pt[:n_prompt] >= 0).flatten()
    order = idx[torch.argsort(pt[idx] * (h.shape[0] + 1) + idx, stable=True)]  # patch-major, frames in order
    hp = h[order]
    sim = torch.full((len(order),), IGNORE, device=h.device)
    if len(order) > 1:
        cos = (hp[1:] * hp[:-1]).sum(-1) / (hp[1:].norm(dim=-1) * hp[:-1].norm(dim=-1))
        same = pt[order[1:]] == pt[order[:-1]]
        sim[1:] = torch.where(same, cos, torch.full_like(cos, IGNORE))
    count = int((sim >= float(f(st.s_th))).sum())
    budget, infeasible = pruning_ratio(st.sparsity, st.cost)
    st.infeasible |= infeasible
    above = float(f(count) / f(st.frame_tok)) if st.frame_tok else float("nan")
    if above < budget:
        k, kind = count, "merge"
        st.sparsity.append(above)
        st.merging_done = above < float(f(st.r_min))
    else:
        k, kind = int(f(budget) * f(st.frame_tok)), "merge_capped"
        st.merging_done = st.pruning_done = True
    marked = torch.zeros(len(order), dtype=torch.bool, device=h.device)
    marked[torch.argsort(sim, descending=True, stable=True)[:k]] = True
    # Each run of marked patch-major positions merges into the unmarked one before it: their mean.
    head = torch.cummax(torch.where(marked, -1, torch.arange(len(order), device=h.device)), dim=0).values
    out = h.clone()
    sums = torch.zeros_like(hp).index_add_(0, head, hp)
    counts = torch.zeros(len(order), device=h.device).index_add_(0, head, torch.ones(len(order), device=h.device))
    heads = ~marked
    out[order[heads]] = sums[heads] / counts[heads][:, None]
    keep = torch.ones(h.shape[0], dtype=torch.bool, device=h.device)
    keep[order[marked]] = False
    st.frame_tok -= k
    st.events.append((layer, kind, k))
    return out, keep


def prune_event(st: FFState, importance: torch.Tensor, n_prompt: int, layer: int):
    """Keep the image-span tokens of most importance; returns keep (S,)."""
    f = np.float32
    ratio, infeasible = pruning_ratio(st.sparsity, st.cost)
    st.infeasible |= infeasible
    span_len = st.image_len - (st.orig_len - n_prompt)
    x = float(f(span_len) * (f(1.0) - f(ratio)))
    k_keep = 0 if math.isnan(x) else round(x)
    keep = torch.ones(importance.shape[0], dtype=torch.bool, device=importance.device)
    span = torch.arange(st.image_start, st.image_start + span_len, device=importance.device)
    order = torch.argsort(importance[span], descending=True, stable=True)
    keep[span[order[k_keep:]]] = False
    st.pruning_done = True
    st.events.append((layer, "prune", span_len - k_keep))
    return keep


# ---------------------------------------------------------------------------
# The decoder (Qwen2 / InternLM2: RMSNorm, GQA with RoPE, SwiGLU)


@dataclasses.dataclass
class Prompt:
    embeds: torch.Tensor  # (S, D) fp32
    patch_type: torch.Tensor  # (S,) int64: -1 text, else the patch id within its frame
    image_start: int
    image_len: int  # the image span's length, text between frames included
    patch_num: int


@dataclasses.dataclass
class Pass:
    """One sampled request on its way through the decoder's layers."""
    st: FFState
    h: torch.Tensor  # (S, D) the compressed prompt's rows, then the served tokens'
    pt: torch.Tensor  # (S,) patch type
    pos: torch.Tensor  # (S,) rotary positions
    n_prompt: int  # rows of ``h`` that are the prompt's


class Decoder:
    """The decoder's weights as one seeded draw (bf16 stacks), rounded per
    ``precision`` a layer at a time as the forward pass reaches it, and
    freed after it. A kind's own decoder may subclass it: one larger than
    the card overrides ``layer`` to draw layer l's leaves only then, each
    from its own stream (``weights.Draws(..., key=(leaf, l))``); another
    feed-forward overrides ``mlp``."""

    def __init__(self, text: dict, tensors: dict, precision: Precision):
        self.text, self.w, self.precision = text, tensors, precision

    def layer(self, l: int) -> dict:
        lw = self.w["layers"]
        out = {name: decoder_matrix(lw[name][l], self.precision)
               for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
        for name in ("ln1", "ln2", "bq", "bk", "bv"):
            if name in lw:
                out[name] = lw[name][l].float()
        return out

    def mlp(self, lw: dict, x: torch.Tensor) -> torch.Tensor:
        return (torch.nn.functional.silu(x @ lw["w_gate"]) * (x @ lw["w_up"])) @ lw["w_down"]

    def embed(self, ids) -> torch.Tensor:
        return self.w["embed"][torch.as_tensor(ids, dtype=torch.long, device=self.w["embed"].device)].float()

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        x = rms_norm(h, self.w["final_norm"], self.text["rms_norm_eps"])
        head = self.w["lm_head"].float()
        return torch.cat([x[i:i + 256] @ head for i in range(0, x.shape[0], 256)])

    def forward(self, prompts: list, served: list, ff: dict) -> list:
        """Each compressed prompt and then its served tokens, in one causal
        pass, layer-major over the prompts: layer l is made once (``layer``),
        every prompt goes through it, and it is freed before layer l + 1. A
        prompt's FrameFusion events at a layer depend on its own input to
        that layer alone, so each reads as it would alone. Returns, a
        prompt, (logits (n, V): row j predicts served token j, the events)."""
        passes = [self.start(p, s, ff) for p, s in zip(prompts, served)]
        for l in range(self.text["num_hidden_layers"]):
            lw = self.layer(l)
            for p in passes:
                self.block(p, lw, l)
            del lw
        if any(p.st.infeasible for p in passes):
            raise ValueError("the cost is too small for this prompt")
        return [(self.logits(p.h[p.n_prompt - 1:]), p.st.events) for p in passes]

    def start(self, prompt: Prompt, served: list, ff: dict) -> Pass:
        """The merge before layer 0, and the served tokens after the prompt."""
        st = FFState(cost=ff["cost"], s_th=ff["similarity_lower_bound"], r_min=ff["ratio_lower_bound"],
                     frame_tok=int((prompt.patch_type >= 0).sum()), orig_len=prompt.embeds.shape[0],
                     image_start=prompt.image_start, image_len=prompt.image_len)
        dev = prompt.embeds.device
        h, pt = prompt.embeds, prompt.patch_type
        pos = torch.arange(h.shape[0], device=dev)
        n_prompt = h.shape[0]
        if st.frame_tok:
            h, keep = merge_event(st, h, pt, n_prompt, -1)
            h, pt, pos, n_prompt = h[keep], pt[keep], pos[keep], int(keep.sum())
        # The served tokens decode from the layer-0 cache's length (the
        # upstream DynamicCache's ``get_seq_length``), each one past the last.
        tail = self.embed(served[:-1])
        h = torch.cat([h, tail])
        pos = torch.cat([pos, n_prompt + torch.arange(len(served) - 1, device=dev)])
        pt = torch.cat([pt, torch.full((len(served) - 1,), -1, device=dev, dtype=pt.dtype)])
        return Pass(st=st, h=h, pt=pt, pos=pos, n_prompt=n_prompt)

    def block(self, p: Pass, lw: dict, l: int) -> None:
        """Layer l over one pass: attention, then the merge or prune event
        that falls there, then the feed-forward."""
        t, st = self.text, p.st
        hq, hk = t["num_attention_heads"], t["num_key_value_heads"]
        hd = t.get("head_dim") or t["hidden_size"] // hq
        h = p.h
        x = rms_norm(h, lw["ln1"], t["rms_norm_eps"])
        q, k, v = x @ lw["wq"], x @ lw["wk"], x @ lw["wv"]
        if "bq" in lw:
            q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
        s = h.shape[0]
        q = rope(q.reshape(s, hq, hd), p.pos, t["rope_theta"])
        k = rope(k.reshape(s, hk, hd), p.pos, t["rope_theta"])
        prune_now = not st.done and st.merging_done
        attn, importance = causal_attention(q, k, v.reshape(s, hk, hd), p.n_prompt - 1 if prune_now else -1)
        h = h + attn.reshape(s, hq * hd) @ lw["wo"]
        if not st.done:
            if prune_now:
                keep = prune_event(st, importance[:p.n_prompt], p.n_prompt, l)
                keep = torch.cat([keep, torch.ones(s - p.n_prompt, dtype=torch.bool, device=h.device)])
            else:
                h, keep = merge_event(st, h, p.pt, p.n_prompt, l)
            h, p.pt, p.pos = h[keep], p.pt[keep], p.pos[keep]
            p.n_prompt = int(keep[:p.n_prompt].sum())
        x = rms_norm(h, lw["ln2"], t["rms_norm_eps"])
        p.h = h + self.mlp(lw, x)


def dense_decoder(config: dict, seed: int, device, precision: Precision) -> Decoder:
    """The decoder of a kind whose reference defines none: the dense stacks
    of ``weights.decoder_tensors``, drawn whole in one stream, in the type
    they are served in."""
    tensors: dict = {"layers": {}}
    for path, t in weights.decoder_tensors(config["text"], seed, device, getattr(torch, config["dtype"])):
        node = tensors
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = t
    return Decoder(config["text"], tensors, precision)


def served_gap(logits: torch.Tensor, tokens) -> float:
    """The widest gap by which a token's logit lies below its row's best."""
    tok = torch.as_tensor(tokens, device=logits.device)
    picked = logits.gather(1, tok[:, None])[:, 0]
    return float((logits.max(dim=1).values - picked).max())
