"""The weight transfer: device time of the Bitpack and Bitunpack kernels
(``csrc/bitpack.cu``, ``csrc/bitunpack.cu``) a traced step. Nothing where
no such kernel ran."""
from bench import devtrace


def read(run):
    if run.trace is None:
        return None
    s = run.trace.seconds_of(devtrace.TRANSPORT)
    return 1e3 * s / run.trace.steps if s > 0 else None
