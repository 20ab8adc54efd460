"""Public API: ``apply_framefusion`` and the model-family registry.

Port of ``framefusion_tpu.interface``: ``apply_framefusion`` returns a new,
configured ``FrameFusionModel`` whose engine runs the compressed prefill —
the reference's three knobs, no mutation. This package runs the 1D-RoPE
families; the Qwen2-VL family (mRoPE) is not ported yet and is rejected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import FrameFusionConfig, LLMConfig
from .models.adapters.common import PrefillInputs
from .runtime.engine import CompressionEngine, PrefillResult


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
    (hand-written kernels; plain versions for CPU tensors) or "einsum"
    (plain reference), for the decoder and the tower alike."""

    family: str
    cfg: LLMConfig
    params: dict
    ff: Optional[FrameFusionConfig] = None
    vision: Optional[dict] = None
    attn_impl: str = "flash"
    pool_layers: int = 8
    _engine: Optional[CompressionEngine] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(f"Model family not supported: {self.family}")
        if FAMILIES[self.family].mrope:
            raise NotImplementedError(f"{self.family}: mRoPE families are not ported to PyTorch yet")

    @property
    def spec(self) -> FamilySpec:
        return FAMILIES[self.family]

    def engine(self) -> CompressionEngine:
        if self._engine is None:
            ff = self.ff or FrameFusionConfig(cost=1.0)  # dense placeholder
            self._engine = CompressionEngine(self.params, self.cfg, ff, attn_impl=self.attn_impl,
                                             pool_layers=self.pool_layers)
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
                 eos_token_id: Optional[int] = None, sampler=None, generator=None):
        """Prefill + decode (greedy, or an ``ops.sampling.SamplerConfig``).
        Returns (token_ids, PrefillResult)."""
        result = self.prefill(inputs)
        tokens = self.engine().generate(result, max_new_tokens, eos_token_id=eos_token_id,
                                        sampler=sampler, generator=generator)
        return tokens, result


# Adapters ported so far; the other families are ROADMAP Queue 1 item 11.
_PORTED_ADAPTERS = ("llava_video",)


def get_token_type(family: str):
    """The family's prompt-metadata module: the adapter, whose
    ``build_prefill_inputs`` derives the patch types without enabling
    compression (the reference's ``get_token_type``)."""
    import importlib

    if family not in FAMILIES:
        raise NotImplementedError(f"Model family not supported: {family}")
    module = FAMILIES[family].adapter_module
    if module not in _PORTED_ADAPTERS:
        raise NotImplementedError(f"{family}: its adapter is not ported to PyTorch yet "
                                  "(ROADMAP Queue 1 item 11: the other families)")
    return importlib.import_module(f".models.adapters.{module}", __package__)


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
