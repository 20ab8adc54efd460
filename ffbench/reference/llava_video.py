"""LLaVA-Video's plain reference: SigLIP-so400m to its layer -2, the LLaVA
two-layer GELU projector, 2x2 average pooling with a learned newline token a
pooled row, and the chat prompt around one video block
(``LLaVA-Video-7B-Qwen2``; SigLIP arXiv:2303.15343)."""

from __future__ import annotations

import numpy as np
import torch

from .. import weights
from ..generator import StubTokenizer
from .common import Prompt, Precision, bidir_attention, layer_norm, tower_matrix

MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
TEMPLATE = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n<image>\n{question}<|im_end|>\n<|im_start|>assistant\n")
FRAME_BATCH = 8


def _tower(v: dict, w: dict, pixels: torch.Tensor, precision: Precision) -> torch.Tensor:
    """(B, S, S, 3) pixels -> (B, N, D) hidden states after layer -2."""
    ps, side, d, heads = v["patch_size"], v["image_size"] // v["patch_size"], v["hidden_size"], \
        v["num_attention_heads"]
    b = pixels.shape[0]
    px = pixels[:, : side * ps, : side * ps].reshape(b, side, ps, side, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = px.reshape(b, side * side, ps * ps * 3) @ tower_matrix(w["patch_kernel"].reshape(ps * ps * 3, d), precision)
    x = x + w["patch_bias"].float() + w["pos_embed"].float()[None]
    lw, eps = w["layers"], v["layer_norm_eps"]
    for l in range(v["num_hidden_layers"] + v["feature_layer"] + 1):
        z = layer_norm(x, lw["ln1_w"][l], lw["ln1_b"][l], eps)
        qkv = [(z @ tower_matrix(lw[f"w{n}"][l], precision) + lw[f"b{n}"][l].float()).reshape(b, -1, heads, d // heads)
               for n in "qkv"]
        x = x + bidir_attention(*qkv).reshape(b, -1, d) @ tower_matrix(lw["wo"][l], precision) + lw["bo"][l].float()
        z = layer_norm(x, lw["ln2_w"][l], lw["ln2_b"][l], eps)
        z = torch.nn.functional.gelu(z @ tower_matrix(lw["w_fc1"][l], precision) + lw["b_fc1"][l].float(),
                                     approximate="tanh")
        x = x + z @ tower_matrix(lw["w_fc2"][l], precision) + lw["b_fc2"][l].float()
    return x


def features(config: dict, tower: dict, proj: dict, pixels: np.ndarray, precision: Precision,
             device) -> torch.Tensor:
    """(T, S, S, 3) pixels -> (T * tokens_per_frame, D_llm) video tokens."""
    v = config["vision"]
    side = v["image_size"] // v["patch_size"]
    pooled = side // v["pool_stride"]
    out = []
    for i in range(0, pixels.shape[0], FRAME_BATCH):
        x = _tower(v, tower, torch.from_numpy(pixels[i:i + FRAME_BATCH]).to(device), precision)
        x = torch.nn.functional.gelu(x @ tower_matrix(proj["w1"], precision) + proj["b1"].float())
        x = x @ tower_matrix(proj["w2"], precision) + proj["b2"].float()
        b, dl = x.shape[0], x.shape[-1]
        grid = x.reshape(b, side, side, dl)[:, : pooled * 2, : pooled * 2]
        grid = grid.reshape(b, pooled, 2, pooled, 2, dl).mean(dim=(2, 4))
        newline = proj["image_newline"].float().expand(b, pooled, 1, dl)
        out.append(torch.cat([grid, newline], dim=2).reshape(-1, dl))
    return torch.cat(out)


def prompt(config: dict, question: str, feats: torch.Tensor, embed) -> Prompt:
    """The chat prompt with the video block at ``<image>``; ``embed(ids)``
    gives the text rows."""
    tok = StubTokenizer()
    before, _, after = TEMPLATE.format(question=question).partition("<image>")
    ids_before, ids_after = tok.encode(before), tok.encode(after)
    v = config["vision"]
    pooled = (v["image_size"] // v["patch_size"]) // v["pool_stride"]
    patch_num = pooled * (pooled + 1)
    n_img = feats.shape[0]
    embeds = torch.cat([embed(ids_before), feats, embed(ids_after)])
    pt = torch.full((embeds.shape[0],), -1, dtype=torch.int64, device=feats.device)
    pt[len(ids_before): len(ids_before) + n_img] = torch.arange(patch_num, device=feats.device).repeat(
        n_img // patch_num)
    return Prompt(embeds=embeds, patch_type=pt, image_start=len(ids_before), image_len=n_img, patch_num=patch_num)


def tower_weights(config: dict, seed: int, device) -> tuple:
    """The run's tower and projector draws (the same the program was handed)."""
    dtype = getattr(torch, config["dtype"])
    v = config["vision"]
    return (weights.siglip_tower(v, seed, device, dtype),
            weights.llava_projector(v["hidden_size"], config["text"]["hidden_size"], seed, device, dtype))
