"""Device ms a step in cuDNN's convolutions and their layout transforms
(``buckets.json``'s ``conv`` keywords, after attention's): the DPT head,
its transposed convolutions, the patch embedding and the pose net, over the
traced steps."""

from portbench import flops_dpt


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s, _ = t.kernel_s(lambda name: flops_dpt.kernel_kind(name) == "conv")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
