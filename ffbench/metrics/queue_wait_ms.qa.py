"""Milliseconds a request waits in the loop's queue: from the end of its
``serve.submit`` span to the start of its ``serve.admit`` span (one request
id in both names), over the requests admitted in the traced window whose
submit is in it too. Reads the program spans of ``run.trace.spans``; None
without them."""

from ffbench import spans


def read(run):
    found = getattr(run.trace, "spans", None)
    if run.trace is None or not found:
        return None
    return spans.queue_wait_ms(run.trace, found)
