"""Process start to the first due request: imports, weights, the program's set-up and the warm-up."""


def read(run):
    return run.setup_s
