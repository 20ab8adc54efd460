from .attention import causal_attention_einsum, decode_attention, last_rows_importance, verify_attention
from .rope import apply_rope, rope_cos_sin
from .sampling import SamplerConfig, draw_uniforms, sample_token

__all__ = [
    "causal_attention_einsum",
    "decode_attention",
    "last_rows_importance",
    "verify_attention",
    "apply_rope",
    "rope_cos_sin",
    "SamplerConfig",
    "draw_uniforms",
    "sample_token",
]
