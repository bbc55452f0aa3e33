"""The weight transfer: device time launched under the program's
``transport.materialize`` span (``dist/spec.py::materialize_leaf`` of a
``DIST`` leaf) a traced step: Bitpack, Bitunpack and whatever else the
layer launches. Nothing where the span holds no device work."""
from bench import spantrace


def read(run):
    s = spantrace.per_step(run, "transport.materialize", "device_s")
    return None if s is None else 1e3 * s
