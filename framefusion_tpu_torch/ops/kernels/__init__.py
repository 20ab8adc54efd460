"""The port's hand-written CUDA kernels and the TPU kernels they stand for.

``COUNTERPARTS`` maps every function of ``framefusion_tpu/ops/kernels/``
that reaches ``pl.pallas_call`` (directly or through another function of its
file), plus the Pallas kernel bodies that only the dispatcher launches, by
``file:line`` of its ``def``, to its name and the port kernel that computes
it. ``KERNELS`` gives each port kernel's module here and its CUDA source.
``chip_smoke.py`` builds its kernels line from these two tables, and
PERF.md's kernel table follows them.
"""

from __future__ import annotations

import importlib

_TPU = "framefusion_tpu/ops/kernels"
_CSRC = "framefusion_tpu_torch/csrc"

COUNTERPARTS = {
    f"{_TPU}/flash_prefill.py:33": ("_flash_kernel", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:118": ("_flash_blocked", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:211": ("_flash_blocked_grouped", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:298": ("_flash_grouped", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:382": ("_flash_grouped_multi", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:407": ("_flash_kernel_gm_imp", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:493": ("_imp_grouped_multi", "attn_importance_rows"),
    f"{_TPU}/flash_prefill.py:520": ("_flash_kernel_imp", "flash_attn_fwd"),
    f"{_TPU}/flash_prefill.py:603": ("flash_causal_attention_importance", "attn_importance_rows"),
    f"{_TPU}/flash_prefill.py:719": ("flash_causal_attention", "flash_attn_fwd"),
    f"{_TPU}/matvec_q8.py:53": ("_matvec", "gemv_stacked"),
    f"{_TPU}/matvec_q8.py:78": ("matvec_q8", "gemv_stacked"),
    f"{_TPU}/matvec_q8.py:101": ("matvec_bf16", "gemv_stacked"),
    f"{_TPU}/matvec_q8.py:171": ("matvec_stacked", "gemv_stacked"),
    f"{_TPU}/matvec_q8.py:240": ("matvec_stacked_qkv", "gemv_stacked"),
    f"{_TPU}/matvec_q8.py:333": ("matvec_stacked_gateup", "gemv_gateup"),
    f"{_TPU}/bidir_attention.py:72": ("flash_bidir_attention", "bidir_attn_fwd"),
    f"{_TPU}/sink_prefill.py:102": ("sink_flash_attention", "sink_attn_fwd"),
    f"{_TPU}/decode_attention.py:79": ("ragged_decode_attention", "ragged_decode_attn"),
}

KERNELS = {
    "flash_attn_fwd": ("flash_prefill", f"{_CSRC}/flash_prefill.cu"),
    "attn_importance_rows": ("flash_prefill", f"{_CSRC}/flash_prefill.cu"),
    "gemv_stacked": ("matvec_q8", f"{_CSRC}/matvec.cu"),
    "gemv_gateup": ("matvec_q8", f"{_CSRC}/matvec.cu"),
    "bidir_attn_fwd": ("bidir_attention", f"{_CSRC}/bidir_attention.cu"),
    "sink_attn_fwd": ("sink_prefill", f"{_CSRC}/sink_prefill.cu"),
    "ragged_decode_attn": ("decode_attention", f"{_CSRC}/decode_attention.cu"),
}


def replaces(kernel: str) -> list[str]:
    """``file:line`` of every TPU function ``kernel`` stands for, by file and line."""
    found = [k for k, (_, port) in COUNTERPARTS.items() if port == kernel]
    return sorted(found, key=lambda k: (k.rsplit(":", 1)[0], int(k.rsplit(":", 1)[1])))


def wrapper(kernel: str):
    """The Python wrapper that launches ``kernel`` (it carries ``launches``)."""
    return getattr(importlib.import_module(f".{KERNELS[kernel][0]}", __name__), kernel)


def captured_counts() -> dict:
    """Each kernel's launches its wrapper recorded into CUDA graphs being
    captured, by kernel name."""
    return {name: wrapper(name).captured for name in KERNELS}
