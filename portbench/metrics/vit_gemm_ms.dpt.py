"""Device ms a step in GEMM kernels (``gemm``, ``xmma``, ``cutlass``,
``nvjet``) outside attention and the convolutions, which match first: the
ViT's bf16 linear layers, forward and backward, over the traced steps."""

from portbench import flops_dpt


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s, _ = t.kernel_s(lambda name: flops_dpt.kernel_kind(name) == "gemm")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
