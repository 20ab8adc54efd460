"""Device idle milliseconds inside each admission: the gaps between device
operations that fall within the program's ``serve.admit`` spans (queue
pop, compressed prefill, splice) that start in the traced window, over
their count. Reads the program spans of ``run.trace.spans``; None without
them."""

from ffbench import spans


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return spans.idle_ms_per_span(run.trace, run.trace.spans, "serve.admit")
