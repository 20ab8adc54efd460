"""framefusion_tpu_torch — PyTorch/CUDA port of framefusion_tpu.

FrameFusion compresses the vision tokens of a video LVLM during prefill:
it merges the same patch across adjacent frames while they stay similar,
then prunes once by last-row attention importance to meet a FLOP ``cost``
budget. This package runs that compressed prefill and greedy decode in
PyTorch; the attention and decode-matvec kernels are hand-written CUDA for
Hopper (``csrc/``), each beside a plain PyTorch version that CPU tensors use.

Public surface:
    apply_framefusion(model, cost, similarity_lower_bound, ratio_lower_bound)
"""

from .config import FrameFusionConfig, LLMConfig, qwen2_7b_config, tiny_llm_config

__version__ = "0.1.0"

__all__ = [
    "FrameFusionConfig",
    "LLMConfig",
    "qwen2_7b_config",
    "tiny_llm_config",
]


def __getattr__(name):
    if name == "apply_framefusion":
        from .interface import apply_framefusion

        return apply_framefusion
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
