"""Public API: ``apply_framefusion`` and the model-family registry.

Port of ``framefusion_tpu.interface``: ``apply_framefusion`` returns a new,
configured ``FrameFusionModel`` whose engine runs the compressed prefill —
the reference's three knobs, no mutation. Every family of ``FAMILIES`` has
its adapter: the Qwen2-backed LLaVA-Video, LLaVA-NeXT-Video, MiniCPM-V and
NVILA (1D RoPE), Qwen2-VL and Qwen2.5-VL (mRoPE: (3, S) position ids, 4
importance rows; either tower) and InternVL (the InternLM2 backbone: no qkv
bias).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import FrameFusionConfig, LLMConfig
from .models.adapters.common import PrefillInputs
from .runtime.engine import CompressionEngine, PrefillResult


# The model's attention choices: the engine's two and the default.
ATTN_IMPLS = ("auto", "einsum", "flash")


@dataclasses.dataclass
class FamilySpec:
    name: str
    adapter_module: str
    llm_prefix: str  # weight-import prefix of the language model
    num_importance_queries: int
    default_similarity_lower_bound: float
    qkv_bias: bool = True
    mrope: bool = False


FAMILIES = {
    "llava_video": FamilySpec("llava_video", "llava_video", "model.", 1, 0.6),
    "llava_next_video": FamilySpec("llava_next_video", "llava_next_video", "language_model.model.", 1, 0.6),
    "minicpmv": FamilySpec("minicpmv", "minicpmv", "llm.model.", 1, 0.7),
    "nvila": FamilySpec("nvila", "nvila", "llm.model.", 1, 0.7),
    "qwen2_vl": FamilySpec("qwen2_vl", "qwen2_vl", "model.", 4, 0.5, mrope=True),
    "internvl": FamilySpec("internvl", "internvl", "language_model.model.", 1, 0.5, qkv_bias=False),
}


@dataclasses.dataclass
class FrameFusionModel:
    """A language model's params and config plus (optionally) a FrameFusion
    config. ``vision`` may hold a vision tower for pixels-to-answer
    pipelines (``{"kind", "cfg", "params", "projector"}``, as
    ``weights.load_checkpoint`` attaches it). ``attn_impl`` is "flash"
    (hand-written kernels; plain versions for CPU tensors), "einsum" (the
    plain reference in the model's own dtype) or "auto" (the default, as
    JAX's: "flash" when the params lie on the card, "einsum" otherwise), for
    the decoder and the tower alike (``resolved_attn_impl``). ``mesh``: a
    rank's DeviceMesh when ``params`` is its shard (tensor parallelism,
    ``parallel.sharding``; expert parallelism, ``models.moe``), passed to
    the engine; ``cfg`` stays the whole model's."""

    family: str
    cfg: LLMConfig
    params: dict
    ff: Optional[FrameFusionConfig] = None
    vision: Optional[dict] = None
    attn_impl: str = "auto"
    pool_layers: int = 8
    mesh: Optional[object] = None
    _engine: Optional[CompressionEngine] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(f"Model family not supported: {self.family}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    @property
    def spec(self) -> FamilySpec:
        return FAMILIES[self.family]

    def resolved_attn_impl(self) -> str:
        """``attn_impl`` with "auto" resolved (JAX's ``_resolved_attn_impl``):
        "flash" for params on the card, "einsum" for params on the CPU, where
        JAX's "auto" takes its plain "chunked" path. "auto" never picks the
        plain path for CUDA params: there a kernel that fails raises."""
        if self.attn_impl != "auto":
            return self.attn_impl
        return "flash" if _params_device(self.params).type == "cuda" else "einsum"

    def engine(self) -> CompressionEngine:
        if self._engine is None:
            ff = self.ff or FrameFusionConfig(cost=1.0)  # dense placeholder
            self._engine = CompressionEngine(self.params, self.cfg, ff, attn_impl=self.resolved_attn_impl(),
                                             pool_layers=self.pool_layers, mesh=self.mesh)
        return self._engine

    def prefill(self, inputs: PrefillInputs, mode: str = "fused") -> PrefillResult:
        """Compressed prefill if FrameFusion or a baseline
        (``baselines.replace_forward``) is applied, dense otherwise."""
        is_baseline = getattr(self.engine(), "mode", None) is not None
        if self.ff is None and not is_baseline:
            return self.engine().dense_prefill(inputs.input_embeds, inputs.position_ids)
        return self.engine().prefill(
            inputs.input_embeds, inputs.patch_type, inputs.position_ids,
            patch_num=inputs.patch_num, image_token_start=inputs.image_token_start,
            image_token_length=inputs.image_token_length, mode=mode,
        )

    def generate(self, inputs: PrefillInputs, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, sampler=None, generator=None,
                 speculative: bool = False, draft_len: int = 4, prompt_ids=None):
        """Prefill + decode (greedy, or an ``ops.sampling.SamplerConfig``).
        Returns (token_ids, PrefillResult).

        ``speculative=True`` (greedy only) decodes by prompt-lookup
        draft-and-verify: the same tokens, fewer weight passes when the
        output echoes ``prompt_ids`` or itself (runtime/spec_decode.py)."""
        _check_speculative(speculative, sampler)
        result = self.prefill(inputs)
        if speculative:
            tokens = self.engine().generate_spec(result, max_new_tokens, draft_len=draft_len, prompt_ids=prompt_ids,
                                                 eos_token_id=eos_token_id)
        else:
            tokens = self.engine().generate(result, max_new_tokens, eos_token_id=eos_token_id,
                                            sampler=sampler, generator=generator)
        return tokens, result

    def generate_batch(self, inputs_list, max_new_tokens: int = 64, eos_token_id: Optional[int] = None,
                       sampler=None, generator=None, mode: str = "fused", speculative: bool = False,
                       draft_len: int = 4, prompt_ids=None):
        """Batched serving: the prefills, then one batched decode of them all
        (``CompressionEngine.generate_batch``). ``mode="planned_batch"``
        with FrameFusion applied runs every prefill as one lockstep batch
        (``prefill_planned_batch``; the inputs share one ``patch_num``); any
        other mode, a dense model or a baseline prefills per request (a
        dense or baseline engine has no batched prefill; "planned_batch"
        then means "fused"). ``speculative=True`` (greedy only) decodes the
        batch by draft-and-verify (``generate_spec_batch``: the same tokens
        as the plain batched greedy decode); ``prompt_ids`` is then one text
        id list (or None) a request. Returns (per-request token lists,
        PrefillResults)."""
        _check_speculative(speculative, sampler)
        is_baseline = getattr(self.engine(), "mode", None) is not None
        if mode == "planned_batch" and self.ff is not None and not is_baseline:
            pn = inputs_list[0].patch_num
            if any(i.patch_num != pn for i in inputs_list):
                raise ValueError("generate_batch: a planned batch takes one patch_num (one vision geometry)")
            results = self.engine().prefill_planned_batch(
                [(i.input_embeds, i.patch_type, i.position_ids, i.image_token_start, i.image_token_length)
                 for i in inputs_list], patch_num=pn)
        else:
            per_request = "fused" if mode == "planned_batch" else mode
            results = [self.prefill(inp, mode=per_request) for inp in inputs_list]
        if speculative:
            tokens = self.engine().generate_spec_batch(results, max_new_tokens, draft_len=draft_len,
                                                       prompt_ids=prompt_ids, eos_token_id=eos_token_id)
        else:
            tokens = self.engine().generate_batch(results, max_new_tokens, eos_token_id=eos_token_id,
                                                  sampler=sampler, generator=generator)
        return tokens, results

    def serving_loop(self, **kwargs):
        """The continuous-batching scheduler on this model's engine
        (``runtime.serving.ServingLoop``): submit ``ServeRequest``s, then
        ``run()``. Requests join freed slots mid-flight; each one's tokens
        equal its solo greedy decode. Kwargs: max_slots, max_new_cap,
        chunk_steps, draft_len (speculative serving), prefix_cap,
        prefill_mode, seed_cap, tail_pool."""
        from .runtime.serving import ServingLoop

        return ServingLoop(self.engine(), **kwargs)


def _params_device(params) -> torch.device:
    """The device of the first tensor in a params tree (the CPU for none)."""
    for value in params.values():
        if isinstance(value, torch.Tensor):
            return value.device
        if isinstance(value, dict) and value:
            return _params_device(value)
    return torch.device("cpu")


def _check_speculative(speculative: bool, sampler) -> None:
    if speculative and sampler is not None:
        raise ValueError("speculative decoding is greedy only: pass no sampler")


def get_token_type(family: str):
    """The family's prompt-metadata module: the adapter, whose
    ``build_prefill_inputs`` derives the patch types without enabling
    compression (the reference's ``get_token_type``)."""
    import importlib

    if family not in FAMILIES:
        raise NotImplementedError(f"Model family not supported: {family}")
    return importlib.import_module(f".models.adapters.{FAMILIES[family].adapter_module}", __package__)


def apply_framefusion(model, cost, similarity_lower_bound, ratio_lower_bound):
    """Configure FrameFusion on a model — the reference's entry point, same
    signature and knob semantics. Returns a new ``FrameFusionModel``."""
    if not isinstance(model, FrameFusionModel):
        raise NotImplementedError(
            f"Model not supported\nModel type: {type(model)}\n"
            "apply_framefusion expects a framefusion_tpu_torch FrameFusionModel."
        )
    ff = FrameFusionConfig(
        cost=cost,
        similarity_lower_bound=similarity_lower_bound,
        ratio_lower_bound=ratio_lower_bound,
        num_importance_queries=model.spec.num_importance_queries,
    )
    return dataclasses.replace(model, ff=ff, _engine=None)
