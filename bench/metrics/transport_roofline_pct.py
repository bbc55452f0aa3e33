"""The transfer's kernels against their roofline: the least time of the
bytes one step's transfer needs (``bench.yardstick.transport_bytes``,
over 3.35 TB/s) over the Bitpack and Bitunpack kernels' device time a
traced step. Nothing where no such kernel ran."""
from bench import devtrace, yardstick


def read(run):
    if run.trace is None or run.transport_bytes_per_step <= 0:
        return None
    s = run.trace.seconds_of(devtrace.TRANSPORT) / run.trace.steps
    if s <= 0:
        return None
    return 100.0 * run.transport_bytes_per_step / yardstick.HBM_BYTES_PER_S / s
