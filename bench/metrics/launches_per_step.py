"""Host dispatch: device kernels launched a traced step (copies and sets
not counted)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.steps
