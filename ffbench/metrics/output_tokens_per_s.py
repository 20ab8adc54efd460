"""Answer tokens the host read back in the window, over the window's seconds.

The tokens of answers retired in the window and those of the answers still
decoding at its close (the loop's per-slot emitted counts, read with every
chunk): retired answers alone would move in steps of a whole answer."""

from ffbench import stats


def read(run):
    return stats.rate(run.window.tokens, run.window.seconds)
