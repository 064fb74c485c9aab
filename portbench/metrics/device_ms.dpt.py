"""Device-busy ms a step of a DPT depth net's training over the traced
steps (the union of kernel, copy and memset intervals)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 1e3 * t.busy_s / run.layer["trace_steps"]
