"""The AWP monitor: device time launched under the program's
``awp.monitor`` span (the l2norm kernels and the per-leaf sums) a traced
step."""
from bench import spantrace


def read(run):
    s = spantrace.per_step(run, "awp.monitor", "device_s")
    return None if s is None else 1e3 * s
