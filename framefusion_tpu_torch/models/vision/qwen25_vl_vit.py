"""Qwen2.5-VL vision transformer, the ``visual`` tower (port of
``framefusion_tpu.models.vision.qwen25_vl_vit``).

What differs from the Qwen2-VL tower (``qwen2_vl_vit.py``), per HF
``Qwen2_5_VisionTransformerPretrainedModel``:

  * the tokens are permuted into window order (merge units of
    spatial_merge_size^2 patches, regrouped by HF's ``get_window_index``);
    most blocks attend within ``window_size``-pixel windows (ragged at the
    grid's edges), the ``fullatt_block_indexes`` blocks within whole frames;
    the merger's output is permuted back;
  * RMSNorm (no bias) for norm1, norm2 and the merger's ln_q; a SwiGLU MLP
    with biases (gate, up, down; silu);
  * the patch embedding, the 2D rotary and the PatchMerger otherwise as in
    Qwen2-VL.

Attention paths (``encode_video``'s ``attn_impl``):

  * ``"flash"``: the full-attention blocks run kernel E
    (ops/kernels/bidir_attention.py) with one frame a batch row, B =
    grid_t, N = grid_h * grid_w (its plain version for CPU tensors); the
    window blocks run the JAX tower's padded-window product: the tokens
    gather into (n_windows, window_cap) slots (host indices a grid; the
    ragged edge windows' empty slots are masked keys), one batched fp32
    score product through ``torch.matmul``, softmax, the product with V,
    and a gather back. The JAX tower computes these outside any Pallas
    kernel, so they stay plain torch here.
  * ``"einsum"``: every block plain (the full-attention blocks as a batched
    fp32 product per frame), the JAX tower's path off the TPU.
  * ``"masked"``: the O(N^2) segment-mask oracle (one (N, N) product with
    the windows or frames as segment ids), for tests at tiny grids.

The tower's parameters live in ``cfg.dtype``, as the Qwen2-VL tower's do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.kernels.bidir_attention import flash_bidir_attention
from ...weights import resolve_device, to_numpy
from ..qwen2 import layer_slice
from .qwen2_vl_vit import Qwen2VLViTConfig, _rotate_half, vision_rope_cos_sin

ATTN_IMPLS = ("einsum", "flash", "masked")


@dataclasses.dataclass(frozen=True)
class Qwen25VLViTConfig:
    """The tower's geometry; the defaults are Qwen2.5-VL-7B's (and 72B's,
    whose tower differs only in ``out_hidden_size`` 8192)."""

    hidden_size: int = 1280  # the tower's width (HF vision_config.hidden_size)
    depth: int = 32
    num_heads: int = 16
    intermediate_size: int = 3420
    patch_size: int = 14
    temporal_patch_size: int = 2
    in_channels: int = 3
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)
    out_hidden_size: int = 3584  # the LLM's width (the merger's output)
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tokens_per_second: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


def tiny_qwen25vl_vit_config(**kw) -> Qwen25VLViTConfig:
    base = dict(hidden_size=64, depth=3, num_heads=4, intermediate_size=96, patch_size=7, window_size=28,
                fullatt_block_indexes=(1,), out_hidden_size=32)
    base.update(kw)
    return Qwen25VLViTConfig(**base)


def init_params(cfg: Qwen25VLViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random-normal weights (scale 0.02) drawn from ``generator`` in
    ``cfg.dtype`` on ``device`` (the generator's device by default)."""
    device = torch.device(device) if device is not None else generator.device

    def norm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    d, i, n_l, mu = cfg.hidden_size, cfg.intermediate_size, cfg.depth, cfg.merge_unit
    layers = {
        "ln1_w": ones(n_l, d), "ln2_w": ones(n_l, d),
        "w_qkv": norm(n_l, d, 3 * d), "b_qkv": zeros(n_l, 3 * d), "wo": norm(n_l, d, d), "bo": zeros(n_l, d),
        "w_gate": norm(n_l, d, i), "b_gate": zeros(n_l, i), "w_up": norm(n_l, d, i), "b_up": zeros(n_l, i),
        "w_down": norm(n_l, i, d), "b_down": zeros(n_l, d),
    }
    return {
        "patch_proj": norm(cfg.patch_dim, d),
        "layers": layers,
        "merger_ln_w": ones(d),
        "merger_w0": norm(mu * d, mu * d), "merger_b0": zeros(mu * d),
        "merger_w1": norm(mu * d, cfg.out_hidden_size), "merger_b1": zeros(cfg.out_hidden_size),
    }


def params_from_hf(state_dict, cfg: Qwen25VLViTConfig, prefix: str = "visual.", device=None) -> dict:
    """HF ``Qwen2_5_VisionTransformerPretrainedModel`` weights in
    ``cfg.dtype``; ``state_dict`` maps names to numpy arrays or tensors.
    ``device``: the card when None (which raises without one); ``"cpu"``
    for the CPU."""
    device = resolve_device(device)
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=device, dtype=cfg.dtype)

    def stack(fmt, transpose=False):
        arrs = [to_numpy(sd[fmt.format(i)]) for i in range(cfg.depth)]
        return tensor(np.stack([a.T if transpose else a for a in arrs]))

    pre = "blocks.{}."
    layers = {
        "ln1_w": stack(pre + "norm1.weight"), "ln2_w": stack(pre + "norm2.weight"),
        "w_qkv": stack(pre + "attn.qkv.weight", True), "b_qkv": stack(pre + "attn.qkv.bias"),
        "wo": stack(pre + "attn.proj.weight", True), "bo": stack(pre + "attn.proj.bias"),
        "w_gate": stack(pre + "mlp.gate_proj.weight", True), "b_gate": stack(pre + "mlp.gate_proj.bias"),
        "w_up": stack(pre + "mlp.up_proj.weight", True), "b_up": stack(pre + "mlp.up_proj.bias"),
        "w_down": stack(pre + "mlp.down_proj.weight", True), "b_down": stack(pre + "mlp.down_proj.bias"),
    }
    # The Conv3d kernel (D, C, tp, p, p) as the (C*tp*p*p -> D) matmul over
    # the processor's flattened patch rows (stride == kernel).
    kernel = to_numpy(sd["patch_embed.proj.weight"]).reshape(cfg.hidden_size, cfg.patch_dim).T
    return {
        "patch_proj": tensor(kernel),
        "layers": layers,
        "merger_ln_w": tensor(to_numpy(sd["merger.ln_q.weight"])),
        "merger_w0": tensor(to_numpy(sd["merger.mlp.0.weight"]).T),
        "merger_b0": tensor(to_numpy(sd["merger.mlp.0.bias"])),
        "merger_w1": tensor(to_numpy(sd["merger.mlp.2.weight"]).T),
        "merger_b1": tensor(to_numpy(sd["merger.mlp.2.bias"])),
    }


def _rmsnorm(x, w, eps):
    """HF's Qwen2RMSNorm: the statistics in fp32, cast back, then the weight."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def window_layout(grid_t: int, grid_h: int, grid_w: int, cfg: Qwen25VLViTConfig):
    """Host numpy window bookkeeping for one grid (HF ``get_window_index``):
    (window_index (n_units,), token_perm (N,), inv_perm (N,), seg_window
    (N,), seg_full (N,)). The ``seg_*`` arrays are segment ids in the
    permuted order; attention is masked to equal ids."""
    m = cfg.spatial_merge_size
    llm_h, llm_w = grid_h // m, grid_w // m
    win = cfg.window_size // m // cfg.patch_size  # merge units a window side
    mu = cfg.merge_unit

    index = np.arange(grid_t * llm_h * llm_w).reshape(grid_t, llm_h, llm_w)
    # HF pads by (win - llm % win) even when llm % win == 0: a whole extra
    # block of -100s, which drops out below. Kept as HF has it.
    pad_h = win - llm_h % win
    pad_w = win - llm_w % win
    nwh = (llm_h + pad_h) // win
    nww = (llm_w + pad_w) // win
    padded = np.full((grid_t, llm_h + pad_h, llm_w + pad_w), -100, np.int64)
    padded[:, :llm_h, :llm_w] = index
    padded = padded.reshape(grid_t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4)
    padded = padded.reshape(grid_t, nwh * nww, win, win)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)  # units a window
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]

    cu_window = np.concatenate([[0], np.cumsum(seqlens) * mu])
    cu_window = cu_window[np.concatenate([[True], np.diff(cu_window) != 0])]

    n = grid_t * grid_h * grid_w
    token_perm = (window_index[:, None] * mu + np.arange(mu)[None, :]).reshape(-1)
    inv_perm = np.argsort(token_perm)

    seg_window = np.zeros(n, np.int32)
    for wi in range(len(cu_window) - 1):
        seg_window[cu_window[wi]: cu_window[wi + 1]] = wi
    # The full-attention blocks segment by frame: the permutation stays
    # within each frame, so frames remain contiguous in the permuted order.
    seg_full = np.repeat(np.arange(grid_t, dtype=np.int32), grid_h * grid_w)
    return window_index, token_perm, inv_perm, seg_window, seg_full


def padded_window_layout(grid_t: int, grid_h: int, grid_w: int, cfg: Qwen25VLViTConfig):
    """Host numpy indices of the padded-window attention layout.

    Windows are contiguous spans of the permuted token order of varying
    length. Padding each to ``window_cap`` = (window_size / merge /
    patch)^2 * merge_unit tokens (64 at the published geometry) turns the
    ragged windows into one batched product; the empty slots are masked
    keys. Returns (win_gather (nw, cap): indices into the permuted rows, with
    ``n`` for an empty slot; win_valid (nw, cap) bool; back_idx (n,): each
    permuted row's flat slot)."""
    m = cfg.spatial_merge_size
    win = cfg.window_size // m // cfg.patch_size
    mu = cfg.merge_unit
    n = grid_t * grid_h * grid_w
    llm_h, llm_w = grid_h // m, grid_w // m
    pad_h, pad_w = win - llm_h % win, win - llm_w % win
    nwh, nww = (llm_h + pad_h) // win, (llm_w + pad_w) // win
    padded = np.zeros((grid_t, llm_h + pad_h, llm_w + pad_w), np.int64)
    padded[:, :llm_h, :llm_w] = 1
    padded = padded.reshape(grid_t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4)
    tok_lens = padded.reshape(grid_t * nwh * nww, -1).sum(axis=1) * mu
    starts = np.concatenate([[0], np.cumsum(tok_lens)])[:-1]
    keep = tok_lens > 0  # HF's always-pad quirk makes wholly empty windows: dropped
    starts, tok_lens = starts[keep], tok_lens[keep]
    cap = win * win * mu
    slots = np.arange(cap, dtype=np.int64)
    win_valid = slots[None, :] < tok_lens[:, None]
    win_gather = np.where(win_valid, starts[:, None] + slots[None, :], n)
    # The valid slots enumerate permuted rows 0..n-1 in order (the windows
    # tile the permuted sequence), so the way back is one flat gather.
    back_idx = np.flatnonzero(win_valid.reshape(-1))
    assert back_idx.shape == (n,)
    return win_gather, win_valid, back_idx


def _vision_rope(grid_h: int, grid_w: int, cfg: Qwen25VLViTConfig, device=None):
    """(h*w, head_dim) fp32 cos / sin in merge-block order: the Qwen2-VL
    tower's table (HF shares ``rot_pos_emb``)."""
    proxy = Qwen2VLViTConfig(embed_dim=cfg.hidden_size, num_heads=cfg.num_heads, patch_size=cfg.patch_size,
                             spatial_merge_size=cfg.spatial_merge_size, rope_theta=cfg.rope_theta)
    return vision_rope_cos_sin(grid_h, grid_w, proxy, device)


def window_attention(q, k, v, win_gather, key_ok, back_idx, scale: float):
    """The window blocks' attention, the JAX tower's padded-window product.

    q, k, v: (N, H, hd) in the permuted order; win_gather: (nw * cap,)
    indices into the rows with N for an empty slot; key_ok: (nw, 1, 1, cap)
    bool; back_idx: (N,) flat slots. fp32 scores over the gathered windows,
    masked keys at -1e30, softmax, probabilities cast to V's dtype, the
    product with V in fp32, then the gather back. Returns (N, H, hd) in
    q's dtype."""
    _, h, hd = q.shape
    nw, cap = key_ok.shape[0], key_ok.shape[-1]
    pad = q.new_zeros((1, h, hd))

    def windows(t):  # (nw, H, cap, hd) fp32
        rows = torch.cat([t, pad]).index_select(0, win_gather)
        return rows.reshape(nw, cap, h, hd).permute(0, 2, 1, 3).to(torch.float32)

    qw, kw, vw = windows(q), windows(k), windows(v)
    scores = torch.matmul(qw, kw.transpose(-1, -2)) * scale
    scores = torch.where(key_ok, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).to(torch.float32)
    out = torch.matmul(probs, vw).permute(0, 2, 1, 3).reshape(nw * cap, h, hd)
    return out.index_select(0, back_idx).to(q.dtype)


def _frame_attention(q, k, v, grid_t: int, scale: float):
    """Full attention within each frame, plain: (N, H, hd) -> (N, H, hd)."""
    n, h, hd = q.shape
    qf, kf, vf = (t.reshape(grid_t, n // grid_t, h, hd).to(torch.float32) for t in (q, k, v))
    probs = torch.softmax(torch.einsum("tqhd,tkhd->thqk", qf, kf) * scale, dim=-1)
    out = torch.einsum("thqk,tkhd->tqhd", probs.to(v.dtype).to(torch.float32), vf)
    return out.reshape(n, h, hd).to(q.dtype)


def _masked_attention(q, k, v, seg, scale: float):
    """The oracle: one (N, N) product, keys masked to the query's segment."""
    scores = torch.einsum("qhd,khd->hqk", q.to(torch.float32), k.to(torch.float32)) * scale
    scores = torch.where((seg[:, None] == seg[None, :])[None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).to(torch.float32)
    return torch.einsum("hqk,khd->qhd", probs, v.to(torch.float32)).to(q.dtype)


def encode_video(params: dict, patches, grid_t: int, grid_h: int, grid_w: int, cfg: Qwen25VLViTConfig,
                 attn_impl: str = "flash") -> torch.Tensor:
    """Encode one video's pixel patches to LLM embedding rows.

    Args:
        patches: (grid_t * grid_h * grid_w, C*tp*p*p) flattened pixel
            patches in the HF processor's layout (``qwen2_vl_vit.
            pixels_to_patches``, the same for both towers), a tensor or
            numpy array; moved to the params' device and ``cfg.dtype``.
        attn_impl: "flash", "einsum" or "masked" (module docstring).
    Returns:
        (grid_t * grid_h * grid_w / merge^2, out_hidden_size): one row per
        merged 2x2 block in the original (not the window) order, the layout
        spliced into the prompt.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl: {attn_impl} (one of {ATTN_IMPLS})")
    n, hw = grid_t * grid_h * grid_w, grid_h * grid_w
    nh, hd, mu = cfg.num_heads, cfg.head_dim, cfg.merge_unit
    if tuple(patches.shape) != (n, cfg.patch_dim):
        raise ValueError(f"patches {tuple(patches.shape)} do not match the grid ({grid_t}, {grid_h}, {grid_w}): "
                         f"want ({n}, {cfg.patch_dim})")
    scale = 1.0 / hd ** 0.5
    dev = params["patch_proj"].device

    window_index, token_perm, _, seg_window, seg_full = window_layout(grid_t, grid_h, grid_w, cfg)
    perm = torch.from_numpy(token_perm).to(dev)
    cos1, sin1 = _vision_rope(grid_h, grid_w, cfg, dev)  # (hw, hd): one frame
    cos = cos1.repeat(grid_t, 1).index_select(0, perm)[:, None, :]
    sin = sin1.repeat(grid_t, 1).index_select(0, perm)[:, None, :]
    x = torch.as_tensor(patches).to(device=dev, dtype=cfg.dtype) @ params["patch_proj"]  # (N, D)
    x = x.index_select(0, perm)

    if attn_impl == "masked":
        seg = {False: torch.from_numpy(seg_window).to(dev), True: torch.from_numpy(seg_full).to(dev)}
    else:
        wg, wv, back = padded_window_layout(grid_t, grid_h, grid_w, cfg)
        win_gather = torch.from_numpy(wg.reshape(-1)).to(dev)
        key_ok = torch.from_numpy(wv).to(dev)[:, None, None, :]
        back_idx = torch.from_numpy(back).to(dev)

    def attend(q, k, v, full_att: bool):
        if attn_impl == "masked":
            return _masked_attention(q, k, v, seg[full_att], scale)
        if not full_att:
            return window_attention(q, k, v, win_gather, key_ok, back_idx, scale)
        if attn_impl == "flash":
            return flash_bidir_attention(q.reshape(grid_t, hw, nh, hd), k.reshape(grid_t, hw, nh, hd),
                                         v.reshape(grid_t, hw, nh, hd), scale=scale).reshape(n, nh, hd)
        return _frame_attention(q, k, v, grid_t, scale)

    def rope(t):
        tf = t.to(torch.float32)
        return (tf * cos + _rotate_half(tf) * sin).to(t.dtype)

    for l in range(cfg.depth):
        lp = layer_slice(params["layers"], l)
        z = _rmsnorm(x, lp["ln1_w"], cfg.rms_norm_eps)
        qkv = (z @ lp["w_qkv"] + lp["b_qkv"]).reshape(n, 3, nh, hd)
        out = attend(rope(qkv[:, 0]), rope(qkv[:, 1]), qkv[:, 2].contiguous(), l in cfg.fullatt_block_indexes)
        x = x + (out.reshape(n, cfg.hidden_size).to(x.dtype) @ lp["wo"] + lp["bo"])
        z = _rmsnorm(x, lp["ln2_w"], cfg.rms_norm_eps)
        gated = torch.nn.functional.silu(z @ lp["w_gate"] + lp["b_gate"]) * (z @ lp["w_up"] + lp["b_up"])
        x = x + (gated @ lp["w_down"] + lp["b_down"])

    z = _rmsnorm(x, params["merger_ln_w"], cfg.rms_norm_eps).reshape(n // mu, mu * cfg.hidden_size)
    z = torch.nn.functional.gelu(z @ params["merger_w0"] + params["merger_b0"])  # exact (erf) GELU
    z = z @ params["merger_w1"] + params["merger_b1"]
    # The merger's rows are merge units in window order; HF's
    # hidden_states[reverse_indices] puts them back in the original order.
    return z.index_select(0, torch.from_numpy(np.argsort(window_index)).to(dev))
