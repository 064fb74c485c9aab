"""Device ms a step in float32 GEMMs outside the convolutions (``f32_gemm``:
geometry/ops.py's projections) over the traced steps."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s = t.bucket_s("f32_gemm")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
