"""Share of the admissions in the traced window whose planned prefill fell
back to the fused executor and so ran twice: ``serve.admit`` spans that
hold an ``engine.fallback`` span, over the ``serve.admit`` spans that start
in the window. Reads the program spans of ``run.trace.spans``; None
without them."""

from ffbench import spans


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return spans.fallback_pct(run.trace, run.trace.spans)
