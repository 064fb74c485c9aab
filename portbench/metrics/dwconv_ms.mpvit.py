"""Device ms a step in the depthwise convolutions' own kernels, forward
and backward (``flops_mpvit.kernel_kind`` "dwconv"): MPViT's CPE, CRPE,
patch embeddings and local paths, the block's memory-bound half beside
FA, over the traced steps. Kernels that dense convolutions run too
(cuDNN's ``*_grouped_direct_kernel``, layout conversions) are not
counted."""

from portbench import flops_mpvit


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s, _ = t.kernel_s(lambda name: flops_mpvit.kernel_kind(name) == "dwconv")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
