"""The AWP monitor: device time of the l2norm kernels (``csrc/l2norm.cu``)
a traced step."""
from bench import devtrace


def read(run):
    if run.trace is None:
        return None
    s = run.trace.seconds_of(devtrace.MONITOR)
    return 1e3 * s / run.trace.steps if s > 0 else None
