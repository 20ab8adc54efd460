"""InternVL2.5's plain reference: InternViT-300M (CLS token, layer-scaled
pre-LN blocks, GELU MLP, no final norm), the 0.5 pixel shuffle, ``mlp1``
(LayerNorm, Linear, GELU, Linear), and one ``FrameN: <image>`` line a frame
(``OpenGVLab/InternVL2_5-8B``; InternVL arXiv:2312.14238)."""

from __future__ import annotations

import numpy as np
import torch

from .. import weights
from ..generator import StubTokenizer
from .common import Prompt, Precision, bidir_attention, layer_norm, tower_matrix

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
TEMPLATE = "<|im_start|>user\n{video_prefix}{question}<|im_end|>\n<|im_start|>assistant\n"
FRAME_BATCH = 8


def _tower(v: dict, w: dict, pixels: torch.Tensor, precision: Precision) -> torch.Tensor:
    """(B, S, S, 3) pixels -> (B, 1 + N, D) last hidden states."""
    ps, side, d, heads = v["patch_size"], v["image_size"] // v["patch_size"], v["hidden_size"], \
        v["num_attention_heads"]
    b = pixels.shape[0]
    px = pixels[:, : side * ps, : side * ps].reshape(b, side, ps, side, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = px.reshape(b, side * side, ps * ps * 3) @ tower_matrix(w["patch_kernel"].reshape(ps * ps * 3, d), precision)
    x = x + w["patch_bias"].float()
    x = torch.cat([w["cls_token"].float().expand(b, 1, d), x], dim=1) + w["pos_embed"].float()[None]
    lw, eps = w["layers"], v["layer_norm_eps"]
    for l in range(v["num_hidden_layers"]):
        z = layer_norm(x, lw["ln1_w"][l], lw["ln1_b"][l], eps)
        qkv = []
        for n in "qkv":
            t = z @ tower_matrix(lw[f"w{n}"][l], precision)
            if v["qkv_bias"]:
                t = t + lw[f"b{n}"][l].float()
            qkv.append(t.reshape(b, -1, heads, d // heads))
        attn = bidir_attention(*qkv).reshape(b, -1, d) @ tower_matrix(lw["wo"][l], precision) + lw["bo"][l].float()
        x = x + lw["lambda1"][l].float() * attn
        z = layer_norm(x, lw["ln2_w"][l], lw["ln2_b"][l], eps)
        z = torch.nn.functional.gelu(z @ tower_matrix(lw["w_fc1"][l], precision) + lw["b_fc1"][l].float())
        x = x + lw["lambda2"][l].float() * (z @ tower_matrix(lw["w_fc2"][l], precision) + lw["b_fc2"][l].float())
    return x


def _pixel_shuffle(x: torch.Tensor, r: float) -> torch.Tensor:
    """(B, W, H, C) -> (B, W r, H r, C / r^2), InternVL's view and permute order."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * r), int(c / r)).permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * r), int(w * r), int(c / (r * r)))
    return x.permute(0, 2, 1, 3)


def features(config: dict, tower: dict, proj: dict, pixels: np.ndarray, precision: Precision,
             device) -> torch.Tensor:
    """(T, S, S, 3) pixels -> (T, tokens_per_frame, D_llm) per-frame tokens."""
    v = config["vision"]
    side = v["image_size"] // v["patch_size"]
    out = []
    for i in range(0, pixels.shape[0], FRAME_BATCH):
        x = _tower(v, tower, torch.from_numpy(pixels[i:i + FRAME_BATCH]).to(device), precision)[:, 1:]
        b = x.shape[0]
        x = _pixel_shuffle(x.reshape(b, side, side, -1), v["downsample_ratio"]).reshape(b, -1, x.shape[-1] * 4)
        z = layer_norm(x, proj["ln_w"], proj["ln_b"], 1e-5)
        z = torch.nn.functional.gelu(z @ tower_matrix(proj["w1"], precision) + proj["b1"].float())
        out.append(z @ tower_matrix(proj["w2"], precision) + proj["b2"].float())
    return torch.cat(out)


def prompt(config: dict, question: str, feats: torch.Tensor, embed) -> Prompt:
    """The interleaved prompt: each frame's tokens at its ``<image>``."""
    tok = StubTokenizer()
    n_frames, tpf, _ = feats.shape
    prefix = "".join(f"Frame{i + 1}: <image>\n" for i in range(n_frames))
    segments = TEMPLATE.format(video_prefix=prefix, question=question).split("<image>")
    rows, is_img = [], []
    for i, seg in enumerate(segments):
        ids = tok.encode(seg)
        if ids:
            rows.append(embed(ids))
            is_img.append(torch.zeros(len(ids), dtype=torch.bool))
        if i < n_frames:
            rows.append(feats[i])
            is_img.append(torch.ones(tpf, dtype=torch.bool))
    embeds = torch.cat(rows)
    img = torch.cat(is_img).to(feats.device)
    pt = torch.full((embeds.shape[0],), -1, dtype=torch.int64, device=feats.device)
    pt[img] = torch.arange(tpf, device=feats.device).repeat(n_frames)
    where = torch.nonzero(img).flatten()
    start, end = int(where[0]), int(where[-1])
    return Prompt(embeds=embeds, patch_type=pt, image_start=start, image_len=end - start + 1, patch_num=tpf)


def tower_weights(config: dict, seed: int, device) -> tuple:
    """The run's tower and projector draws (the same the program was handed)."""
    dtype = getattr(torch, config["dtype"])
    v = config["vision"]
    return (weights.internvit_tower(v, seed, device, dtype),
            weights.internvl_projector(v, config["text"]["hidden_size"], seed, device, dtype))
