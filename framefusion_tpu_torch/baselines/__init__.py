from .qwen2_baselines import (
    BaselineEngine,
    compute_density_overhead,
    replace_forward,
    replace_minicpmv_forward,
    replace_nvila_forward,
    replace_qwen2_forward,
    replace_qwenvl_forward,
)

__all__ = [
    "BaselineEngine",
    "compute_density_overhead",
    "replace_forward",
    "replace_minicpmv_forward",
    "replace_nvila_forward",
    "replace_qwen2_forward",
    "replace_qwenvl_forward",
]
