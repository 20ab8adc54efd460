"""Seeded random weights, drawn on the device in the port's parameter layout.

The program and the reference are handed the same weights: each side calls
these functions with the run's seed and gets the same tensors, tensor by
tensor in a fixed order, each drawn in one call in the type it is served in
(bf16 on the card). The program quantizes the decoder's matrices itself as
its set-up does (``framefusion_tpu_torch.ops.quant``); the reference works
the int8 values out again from these draws.

The dense kinds draw their decoder as one stream (``decoder_tensors``),
whole stacks in order. A kind added later draws each (leaf, layer) from a
stream of its own, ``Draws(seed, 0, ..., key=(leaf, layer))``, a child of
the seed that no other leaf or layer shares: either side can then draw
layer l alone, in any order, and a reference larger than the card draws,
rounds and frees one layer at a time.

Layouts (the port's; matrices are ``(K, O)``, applied as ``x @ w``, layer
stacks carry a leading layer axis):

* decoder: ``embed (V, D)``, ``layers`` {``ln1``, ``ln2`` (L, D); ``wq``
  (L, D, Hq*hd); ``wk``, ``wv`` (L, D, Hk*hd); ``wo`` (L, Hq*hd, D);
  ``w_gate``, ``w_up`` (L, D, I); ``w_down`` (L, I, D); ``bq``, ``bk``,
  ``bv`` with a qkv bias}, ``final_norm (D,)``, ``lm_head (D, V)``;
* SigLIP and InternViT towers and their projectors as
  ``models/vision/siglip.py``, ``llava_frontend.py`` and ``internvl_vit.py``
  lay them out.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .generator import STREAM_WEIGHTS, child_seed

# Matrices are drawn at this scale, as the port's own ``init_params`` (a
# configuration block may set its own ``init_std``); biases and norm offsets
# are drawn too, so no bias path runs on zeros.
STD = 0.02


class Draws:
    """One seeded stream of draws on ``device``: every call takes its values
    from the same generator, so two streams of one seed give equal tensors
    when they make the same calls in the same order. ``key``, a leaf's name
    and a layer, gives that (leaf, layer) a stream of its own."""

    def __init__(self, seed: int, part: int, device, dtype, std: float = STD, key: tuple = ()):
        if key:
            leaf, layer = key
            entropy = [int(seed), STREAM_WEIGHTS, part, zlib.crc32(leaf.encode()), int(layer) + 1]
            gen_seed = int(np.random.SeedSequence(entropy).generate_state(1, dtype=np.uint64)[0]) >> 1
        else:
            gen_seed = child_seed(seed, STREAM_WEIGHTS, part + 1)[part]
        self.gen = torch.Generator(device=device).manual_seed(gen_seed)
        self.device, self.dtype, self.std = torch.device(device), dtype, std

    def normal(self, *shape, std=None, mean: float = 0.0) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype).mul_(
            self.std if std is None else std)
        return t.add_(mean) if mean else t


def decoder_tensors(text: dict, seed: int, device, dtype):
    """Yield ``(path, tensor)`` of the decoder, ``path`` a tuple of keys into
    the port's param dict, in draw order."""
    d = Draws(seed, 0, device, dtype, text.get("init_std", STD))
    n_l, dm, i = text["num_hidden_layers"], text["hidden_size"], text["intermediate_size"]
    hq, hk = text["num_attention_heads"], text["num_key_value_heads"]
    hd = text.get("head_dim") or dm // hq
    yield ("embed",), d.normal(text["vocab_size"], dm)
    yield ("layers", "ln1"), d.normal(n_l, dm, std=0.05, mean=1.0)
    yield ("layers", "ln2"), d.normal(n_l, dm, std=0.05, mean=1.0)
    for name, shape in (("wq", (n_l, dm, hq * hd)), ("wk", (n_l, dm, hk * hd)), ("wv", (n_l, dm, hk * hd)),
                        ("wo", (n_l, hq * hd, dm)), ("w_gate", (n_l, dm, i)), ("w_up", (n_l, dm, i)),
                        ("w_down", (n_l, i, dm))):
        yield ("layers", name), d.normal(*shape)
    if text.get("qkv_bias", False):
        yield ("layers", "bq"), d.normal(n_l, hq * hd)
        yield ("layers", "bk"), d.normal(n_l, hk * hd)
        yield ("layers", "bv"), d.normal(n_l, hk * hd)
    yield ("final_norm",), d.normal(dm, std=0.05, mean=1.0)
    yield ("lm_head",), d.normal(dm, text["vocab_size"])


def siglip_tower(vision: dict, seed: int, device, dtype) -> dict:
    """SigLIP weights (``models/vision/siglip.py``'s layout)."""
    d = Draws(seed, 1, device, dtype, vision.get("init_std", STD))
    n_l, dm, i, ps = vision["num_hidden_layers"], vision["hidden_size"], vision["intermediate_size"], \
        vision["patch_size"]
    n_patch = (vision["image_size"] // ps) ** 2
    layers = {"ln1_w": d.normal(n_l, dm, std=0.05, mean=1.0), "ln1_b": d.normal(n_l, dm),
              "ln2_w": d.normal(n_l, dm, std=0.05, mean=1.0), "ln2_b": d.normal(n_l, dm)}
    for name in ("wq", "wk", "wv", "wo"):
        layers[name], layers["b" + name[1]] = d.normal(n_l, dm, dm), d.normal(n_l, dm)
    layers.update(w_fc1=d.normal(n_l, dm, i), b_fc1=d.normal(n_l, i), w_fc2=d.normal(n_l, i, dm),
                  b_fc2=d.normal(n_l, dm))
    return {"patch_kernel": d.normal(ps, ps, 3, dm), "patch_bias": d.normal(dm), "pos_embed": d.normal(n_patch, dm),
            "layers": layers, "post_ln_w": d.normal(dm, std=0.05, mean=1.0), "post_ln_b": d.normal(dm)}


def llava_projector(vision_dim: int, llm_dim: int, seed: int, device, dtype) -> dict:
    """The LLaVA two-layer projector and the ``image_newline`` row
    (``models/vision/llava_frontend.py``'s layout)."""
    d = Draws(seed, 2, device, dtype)
    return {"w1": d.normal(vision_dim, llm_dim), "b1": d.normal(llm_dim), "w2": d.normal(llm_dim, llm_dim),
            "b2": d.normal(llm_dim), "image_newline": d.normal(llm_dim)}


def internvit_tower(vision: dict, seed: int, device, dtype) -> dict:
    """InternViT weights (``models/vision/internvl_vit.py``'s layout, qkv
    bias on, no qk norm)."""
    d = Draws(seed, 1, device, dtype, vision.get("init_std", STD))
    n_l, dm, i, ps = vision["num_hidden_layers"], vision["hidden_size"], vision["intermediate_size"], \
        vision["patch_size"]
    n_patch = (vision["image_size"] // ps) ** 2
    layers = {"ln1_w": d.normal(n_l, dm, std=0.05, mean=1.0), "ln1_b": d.normal(n_l, dm),
              "ln2_w": d.normal(n_l, dm, std=0.05, mean=1.0), "ln2_b": d.normal(n_l, dm),
              "wq": d.normal(n_l, dm, dm), "wk": d.normal(n_l, dm, dm), "wv": d.normal(n_l, dm, dm),
              "wo": d.normal(n_l, dm, dm), "bo": d.normal(n_l, dm), "w_fc1": d.normal(n_l, dm, i),
              "b_fc1": d.normal(n_l, i), "w_fc2": d.normal(n_l, i, dm), "b_fc2": d.normal(n_l, dm),
              "lambda1": d.normal(n_l, dm, mean=0.1), "lambda2": d.normal(n_l, dm, mean=0.1)}
    if vision.get("qkv_bias", True):
        layers.update(bq=d.normal(n_l, dm), bk=d.normal(n_l, dm), bv=d.normal(n_l, dm))
    return {"patch_kernel": d.normal(ps, ps, 3, dm), "patch_bias": d.normal(dm), "cls_token": d.normal(dm),
            "pos_embed": d.normal(n_patch + 1, dm), "layers": layers}


def internvl_projector(vision: dict, llm_dim: int, seed: int, device, dtype) -> dict:
    """InternVL's ``mlp1`` (LayerNorm, Linear, GELU, Linear) after the pixel
    shuffle (``models/vision/internvl_vit.py``'s layout)."""
    d = Draws(seed, 2, device, dtype)
    din = vision["hidden_size"] * int(round(1 / vision["downsample_ratio"])) ** 2
    return {"ln_w": d.normal(din, std=0.05, mean=1.0), "ln_b": d.normal(din), "w1": d.normal(din, llm_dim),
            "b1": d.normal(llm_dim), "w2": d.normal(llm_dim, llm_dim), "b2": d.normal(llm_dim)}
