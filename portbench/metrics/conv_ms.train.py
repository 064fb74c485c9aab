"""Device ms a step in the convolutions (``conv`` of ``buckets.json``: cuDNN's
kernels and their layout transforms) over the traced steps."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s = t.bucket_s("conv")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
