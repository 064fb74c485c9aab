"""Device ms a step in kernel FA, forward and backward (its kernels by
name: ``fa_fwd_*``, ``fa_bwd_*``), over the traced steps."""

from portbench import flops_mpvit


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    s, _ = t.kernel_s(lambda name: flops_mpvit.kernel_kind(name) == "fa")
    return 1e3 * s / run.layer["trace_steps"] if s > 0 else None
