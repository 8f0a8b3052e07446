"""Process start to the end of the warm episode: imports, the kernels'
load (or first build), weights, traffic, one whole episode."""


def read(run):
    return run.setup_s
