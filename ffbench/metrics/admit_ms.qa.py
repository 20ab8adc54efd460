"""Device milliseconds of the work ``loop.step()`` launches outside graph replays
(the admissions' compressed prefills, their splices into the pools,
compactions), per request admitted in the traced window."""


def read(run):
    if run.trace is None:
        return None
    n = len(run.traced_admissions())
    if not n:
        return None
    return 1e3 * run.trace.device_seconds(lambda o: o.range == "step" and not o.graph) / n
