"""Kernels S and T against their byte bound: Σ over their launches in the
traced steps of (bytes read once and written once ÷ the HBM peak), over
their summed device time (``flops.train_kernel_bytes``)."""

import re

from portbench import flops


def read(run):
    t = run.trace
    if t is None:
        return None
    sizes = flops.train_kernel_bytes(run.layer["cfg"])
    bound = spent = 0.0
    for name, n_bytes in sizes.items():
        s, launches = t.kernel_s(lambda k, name=name: _is(k, name))
        bound += launches * n_bytes / run.peaks["hbm_bytes_s"]
        spent += s
    return 100.0 * bound / spent if spent > 0 else None


def _is(kernel: str, name: str) -> bool:
    """The kernel ``name`` and not another whose name it begins
    (``bilinear_sample_kernel`` is not ``bilinear_sample_multi_kernel``):
    the name followed by its template or argument list."""
    return re.search(rf"(^|[\s:]){name}[<(]", kernel) is not None
