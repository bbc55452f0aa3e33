"""The weight transfer: the program's ``transport.bytes`` counter (the
bytes Bitpack and Bitunpack read and write, counted by ``kernels/ops.py``
at each call) a traced step, in GB. Nothing where nothing was packed."""
from bench import spantrace


def read(run):
    n = spantrace.counter_per_step(run, "transport.bytes")
    return None if n is None else n / 1e9
