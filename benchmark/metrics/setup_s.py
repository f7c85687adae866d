"""``setup_s``: the process from its start to the window's first call:
importing, initialising the card, building or loading the kernels,
synthesizing the pool and the warm calls."""


def read(run):
    return run.setup_s
