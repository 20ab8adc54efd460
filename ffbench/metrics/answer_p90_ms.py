"""The 90th percentile (nearest rank) of every due request's time from its due time to its whole answer on the host."""

from ffbench import stats


def read(run):
    return 1e3 * stats.nearest_rank(stats.latencies_s(run.window.records, run.end_s), 90)
