"""Share of the traced window in which no operation ran on the device.

Reads ``idle_share.qa`` and ``idle_share.captions`` alike (``run.Bench.reader``
falls back to the name before the first dot)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
