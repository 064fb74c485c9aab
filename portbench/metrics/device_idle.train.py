"""Share of the traced steps in which no kernel, copy or memset ran on the
card (the union of device intervals over the window)."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
