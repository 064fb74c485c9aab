"""Device-busy ms a step over the traced steps (the union of kernel, copy
and memset intervals): the step's work on the card, without the host's
share of ``train_step_ms``."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 1e3 * t.busy_s / run.layer["trace_steps"]
