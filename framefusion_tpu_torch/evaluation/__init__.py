"""Offline accuracy harness and the lmms-eval shim (port of
``framefusion_tpu.evaluation``)."""

from .harness import LmmsEvalAdapter, PromptEval, evaluate_pair, run_offline_eval

__all__ = ["LmmsEvalAdapter", "PromptEval", "evaluate_pair", "run_offline_eval"]
