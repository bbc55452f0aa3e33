"""End to end: the run's set-up on the host clock, from the start of
``bench/run.py`` to the window: imports, the kernels' build or load, the
weights and batch pool, and the checked warm steps."""


def read(run):
    return run.setup_s
