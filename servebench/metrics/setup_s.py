"""Process start to the window's opening: imports, the kernels' build or
load, the weights, and the warm-up of every class."""


def read(run):
    return run.setup_s
