"""The optimizer: device kernels launched under the program's
``optim.sgd`` span a traced step (copies and sets not counted)."""
from bench import spantrace


def read(run):
    return spantrace.per_step(run, "optim.sgd", "launches")
