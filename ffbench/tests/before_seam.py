"""The check as it stood before a configuration kind could bring its own decoder.

A verbatim copy of ``check.readings`` and ``reference/common.Decoder`` from
before the seam (``reference.decoder``), kept so that a test can hold the
check's readings through the default decoder against the old code on the
same sample: one draw of ``weights.decoder_tensors`` shared by the
reference and the control, each sampled request passed alone through
every layer. The one change to the copy: ``readings`` builds this module's
``Decoder``. The helpers both call (``rms_norm``, ``rope``,
``causal_attention``, ``merge_event``, ``prune_event``, ``FFState``,
``decoder_matrix``, ``served_gap``, ``preprocess``) are the reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ffbench import reference, weights
from ffbench.check import NAMES, _rel
from ffbench.reference import common
from ffbench.reference.common import (FFState, Precision, Prompt, causal_attention, decoder_matrix, merge_event,
                                      prune_event, rms_norm, rope)


def readings(config: dict, seed: int, samples: list, device, control: bool = False) -> dict:
    """{name: largest reading over the samples} for the reference; with
    ``control``, also {"control." + name: ...} for the control, which is
    judged by the reference: its pixels and tokens against the reference's,
    and the reference's logit of the token it puts first at each position."""
    import torch

    ref = reference.load(config["kind"])
    size = config["vision"]["image_size"]
    out = {name: 0.0 for name in NAMES}
    if control:
        out.update({"control." + name: 0.0 for name in NAMES})
    events_differ = control_events_differ = 0
    with common.precise(), torch.no_grad():
        tower, proj = ref.tower_weights(config, seed, device)
        feats = []
        for s in samples:
            px = common.preprocess(s.frames, size, ref.MEAN, ref.STD, common.REFERENCE)
            out["pixel_err"] = max(out["pixel_err"], float(np.abs(s.pixels - px).max()))
            f = ref.features(config, tower, proj, px, common.REFERENCE, device)
            out["feature_err"] = max(out["feature_err"], _rel(s.features.to(device), f.reshape(-1, f.shape[-1])))
            fc = None
            if control:
                pxc = common.preprocess(s.frames, size, ref.MEAN, ref.STD, common.CONTROL)
                out["control.pixel_err"] = max(out["control.pixel_err"], float(np.abs(pxc - px).max()))
                fc = ref.features(config, tower, proj, pxc, common.CONTROL, device)
                out["control.feature_err"] = max(out["control.feature_err"],
                                                 _rel(fc.reshape(-1, fc.shape[-1]), f.reshape(-1, f.shape[-1])))
            feats.append((f, fc))
        del tower, proj
        dec_w: dict = {"layers": {}}
        for path, t in weights.decoder_tensors(config["text"], seed, device, getattr(torch, config["dtype"])):
            node = dec_w
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = t
        dec = Decoder(config["text"], dec_w, common.REFERENCE)
        ctl = Decoder(config["text"], dec_w, common.CONTROL) if control else None
        for s, (f, fc) in zip(samples, feats):
            logits, events = dec.forward(ref.prompt(config, s.request.question, f, dec.embed), s.tokens,
                                         config["framefusion"])
            out["logit_gap"] = max(out["logit_gap"], common.served_gap(logits, s.tokens))
            if s.events is not None and [tuple(e) for e in s.events] != [tuple(e) for e in events]:
                events_differ += 1
            if control:
                logits_c, events_c = ctl.forward(ref.prompt(config, s.request.question, fc, dec.embed), s.tokens,
                                                 config["framefusion"])
                control_events_differ += [tuple(e) for e in events_c] != [tuple(e) for e in events]
                picks = torch.argmax(logits_c, dim=1)
                out["control.logit_gap"] = max(out["control.logit_gap"], common.served_gap(logits, picks))
            del logits
    out["events_differ"] = events_differ
    if control:
        out["control.events_differ"] = control_events_differ
    return out


class Decoder:
    """The decoder's weights as one seeded draw (bf16 stacks), rounded per
    ``precision`` a layer at a time as the forward pass reaches it."""

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

    def embed(self, ids) -> torch.Tensor:
        return self.w["embed"][torch.as_tensor(ids, dtype=torch.long, device=self.w["embed"].device)].float()

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        x = rms_norm(h, self.w["final_norm"], self.text["rms_norm_eps"])
        head = self.w["lm_head"].float()
        return torch.cat([x[i:i + 256] @ head for i in range(0, x.shape[0], 256)])

    def forward(self, prompt: Prompt, served: list, ff: dict):
        """The compressed prompt and then the served tokens, in one causal
        pass. Returns (logits (n, V): row j predicts served token j, the FrameFusion events)."""
        t = self.text
        hq, hk = t["num_attention_heads"], t["num_key_value_heads"]
        hd = t.get("head_dim") or t["hidden_size"] // hq
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
        for l in range(t["num_hidden_layers"]):
            lw = self.layer(l)
            x = rms_norm(h, lw["ln1"], t["rms_norm_eps"])
            q, k, v = x @ lw["wq"], x @ lw["wk"], x @ lw["wv"]
            if "bq" in lw:
                q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
            s = h.shape[0]
            q = rope(q.reshape(s, hq, hd), pos, t["rope_theta"])
            k = rope(k.reshape(s, hk, hd), pos, t["rope_theta"])
            prune_now = not st.done and st.merging_done
            attn, importance = causal_attention(q, k, v.reshape(s, hk, hd), n_prompt - 1 if prune_now else -1)
            h = h + attn.reshape(s, hq * hd) @ lw["wo"]
            if not st.done:
                if prune_now:
                    keep = prune_event(st, importance[:n_prompt], n_prompt, l)
                    keep = torch.cat([keep, torch.ones(s - n_prompt, dtype=torch.bool, device=dev)])
                else:
                    h, keep = merge_event(st, h, pt, n_prompt, l)
                h, pt, pos = h[keep], pt[keep], pos[keep]
                n_prompt = int(keep[:n_prompt].sum())
            x = rms_norm(h, lw["ln2"], t["rms_norm_eps"])
            h = h + (torch.nn.functional.silu(x @ lw["w_gate"]) * (x @ lw["w_up"])) @ lw["w_down"]
            del lw
        if st.infeasible:
            raise ValueError("the cost is too small for this prompt")
        return self.logits(h[n_prompt - 1:]), st.events
