"""End to end: the window's wall time over the whole steps it completed
(host clock; each step ends in the trainer's loss sync)."""


def read(run):
    return run.step_s * 1e3
