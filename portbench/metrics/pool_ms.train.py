"""Device ms a step in the windowed means of the photometric loss (``pool``:
LCC and SSIM) over the traced steps."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s = t.bucket_s("pool")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
