"""Mean host milliseconds a request waits in the serving loop's queue, from
``ServingLoop.submit`` to the start of its admission (``ServeResult.wait_s``,
stamped by the loop on the host clock), over the requests whose admission
started before the traced window opened: inside that window the profiler
slows the host several times over, so a wait read there would be the
profiler's. Without a traced window, every request of the window counts."""


def read(run):
    opened = run.tracer.opened_at
    waits = [r.wait_s for r in run.window.records
             if r.wait_s is not None and (opened is None or r.submit_s + r.wait_s < opened)]
    return 1e3 * sum(waits) / len(waits) if waits else None
