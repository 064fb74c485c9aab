"""Device ms a step in the attention kernels, forward and backward (names
holding ``flash``, ``fmha``, ``sdpa`` or ``attention``: FlashAttention,
the memory-efficient kernel or cuDNN's), over the traced steps."""

from portbench import flops_dpt


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s, _ = t.kernel_s(lambda name: flops_dpt.kernel_kind(name) == "attention")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
