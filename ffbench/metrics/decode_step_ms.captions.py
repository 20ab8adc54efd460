"""Device milliseconds of a replayed decode macro step: the graph replays'
kernels over the number of replays in the traced window."""


def read(run):
    if run.trace is None or not run.trace.graph_launches:
        return None
    return 1e3 * run.trace.device_seconds(lambda o: o.graph) / run.trace.graph_launches
