"""The optimizer: device time launched under the program's ``optim.sgd``
span (``optim/sgd.py::sgd_update``) a traced step."""
from bench import spantrace


def read(run):
    s = spantrace.per_step(run, "optim.sgd", "device_s")
    return None if s is None else 1e3 * s
