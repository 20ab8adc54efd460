"""Device idle milliseconds at each decode chunk boundary: the gaps between
device operations that fall within the program's ``serve.chunk`` spans
(compaction, state upload, graph replay, state read, retirements) that
start in the traced window, over their count.

Reads ``chunk_idle_ms.qa`` and ``chunk_idle_ms.captions`` alike, from the
program spans of ``run.trace.spans``; None without them."""

from ffbench import spans


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return spans.idle_ms_per_span(run.trace, run.trace.spans, "serve.chunk")
