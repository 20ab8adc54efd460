from .attention import causal_attention_einsum, decode_attention, last_rows_importance
from .rope import apply_rope, rope_cos_sin
from .sampling import SamplerConfig, sample_token

__all__ = [
    "causal_attention_einsum",
    "decode_attention",
    "last_rows_importance",
    "apply_rope",
    "rope_cos_sin",
    "SamplerConfig",
    "sample_token",
]
