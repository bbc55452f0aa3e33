"""The loss: device time launched under the program's ``model.loss``
span (the LM's ``lm_loss``, the CNN's log-softmax and NLL) a traced step;
the forward's only, since its backward runs under ``train.backward``."""
from bench import spantrace


def read(run):
    s = spantrace.per_step(run, "model.loss", "device_s")
    return None if s is None else 1e3 * s
