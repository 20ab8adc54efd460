"""Accuracy-regression harness: dense against compressed on the same prompts
(port of ``framefusion_tpu.evaluation.harness``).

The reference measures quality by putting ``apply_framefusion`` inside the
lmms-eval evaluator. This module gives (a) the same shim for lmms-eval where
it is installed (``LmmsEvalAdapter``) and (b) an offline harness that needs
no dataset: for a list of prefill inputs it reports, a prompt at a time,
how far the compressed model's greedy tokens and first-token distribution
stay with the dense model's, as one JSON-able dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PromptEval:
    prompt_tokens: int
    final_tokens: int
    vision_token_reduction: float
    greedy_match_len: int  # longest common greedy prefix, dense against compressed
    greedy_agreement: float  # share of equal positions
    top1_logit_match: bool
    kl_first_token: float


def evaluate_pair(dense_model, ff_model, inputs, max_new_tokens: int = 16) -> PromptEval:
    """One prompt through both models: their prefills, ``max_new_tokens``
    greedy tokens each, and KL(dense || compressed) of the first token's
    distribution, in fp32 on the logits' device."""
    dense_res = dense_model.prefill(inputs)
    ff_res = ff_model.prefill(inputs)
    dense_tokens = dense_model.engine().generate_greedy(dense_res, max_new_tokens)
    ff_tokens = ff_model.engine().generate_greedy(ff_res, max_new_tokens)

    match_len = 0
    for a, b in zip(dense_tokens, ff_tokens):
        if a != b:
            break
        match_len += 1
    agree = float(np.mean([a == b for a, b in zip(dense_tokens, ff_tokens)]))

    p = torch.log_softmax(dense_res.logits.to(torch.float32), dim=-1)
    q = torch.log_softmax(ff_res.logits.to(device=p.device, dtype=torch.float32), dim=-1)
    kl = float(torch.sum(torch.exp(p) * (p - q)))
    top1 = int(torch.argmax(p)) == int(torch.argmax(q))

    t = ff_res.telemetry
    return PromptEval(
        prompt_tokens=int(inputs.input_embeds.shape[0]),
        final_tokens=ff_res.valid_len,
        vision_token_reduction=t.vision_token_reduction if t else 0.0,
        greedy_match_len=match_len,
        greedy_agreement=agree,
        top1_logit_match=top1,
        kl_first_token=kl,
    )


def run_offline_eval(dense_model, ff_model, prompt_list, max_new_tokens: int = 16) -> dict:
    """Evaluate a list of ``PrefillInputs``; returns an aggregate JSON-able
    dict. Each pair's results are released before the next prompt runs."""
    rows = [evaluate_pair(dense_model, ff_model, p, max_new_tokens) for p in prompt_list]
    return {
        "num_prompts": len(rows),
        "mean_reduction": float(np.mean([r.vision_token_reduction for r in rows])),
        "mean_greedy_agreement": float(np.mean([r.greedy_agreement for r in rows])),
        "first_token_match_rate": float(np.mean([r.top1_logit_match for r in rows])),
        "mean_kl_first_token": float(np.mean([r.kl_first_token for r in rows])),
        "per_prompt": [dataclasses.asdict(r) for r in rows],
    }


class LmmsEvalAdapter:
    """lmms-eval model shim (the reference's integration point).

    Register it with lmms-eval as a custom model; ``generate_until`` runs
    the compressed prefill and greedy decode through the adapter's
    tokenizer and vision frontend. It needs the ``lmms_eval`` package and
    real checkpoints, hence the import gate.
    """

    def __init__(self, model, tokenizer, frontend, max_new_tokens: int = 64):
        try:
            import lmms_eval  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "lmms-eval is not installed; use run_offline_eval for the "
                "self-contained accuracy harness"
            ) from e
        self.model = model
        self.tokenizer = tokenizer
        self.frontend = frontend
        self.max_new_tokens = max_new_tokens

    def generate_until(self, requests):
        """lmms-eval's ``generate_until`` contract: each request is an
        ``Instance`` whose ``args`` tuple carries (context, gen_kwargs,
        doc_to_visual, doc_id, task, split); gen_kwargs may set
        ``max_new_tokens`` and ``until`` stop strings (a list or a bare
        string). Returns one decoded string a request, cut at its stop
        strings."""
        outputs = []
        for req in requests:
            args = getattr(req, "args", None)
            gen_kwargs = {}
            if isinstance(args, (tuple, list)) and len(args) > 1 and isinstance(args[1], dict):
                gen_kwargs = args[1]
            inputs = self.frontend(req)
            max_new = int(gen_kwargs.get("max_new_tokens", self.max_new_tokens))
            tokens, _ = self.model.generate(
                inputs, max_new,
                eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
            )
            text = self.tokenizer.decode(tokens)
            until = gen_kwargs.get("until") or []
            if isinstance(until, str):
                until = [until]
            for stop in until:
                cut = text.find(stop)
                if cut >= 0:
                    text = text[:cut]
            outputs.append(text)
        return outputs
