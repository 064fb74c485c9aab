"""Kernel FA against its byte bound: FA's forward calls of a step (the
``FA/fwd`` launch counter around one steady step, ``layer["fa_calls"]``)
over a step's calls (``flops_mpvit.fa_calls``) times the bytes a step's
FA moves once, forward and backward (``flops_mpvit.fa_step_bytes``), at
the card's HBM bandwidth, over ``fa_ms.mpvit``'s device time a step."""

from portbench import flops_mpvit


def read(run):
    t, calls = run.trace, run.layer.get("fa_calls")
    if t is None or not calls:
        return None
    spent, _ = t.kernel_s(lambda name: flops_mpvit.kernel_kind(name) == "fa")
    if spent <= 0:
        return None
    cfg = run.layer["cfg"]
    moved = calls / flops_mpvit.fa_calls(cfg) * flops_mpvit.fa_step_bytes(cfg)
    return 100.0 * moved / run.peaks["hbm_bytes_s"] / (spent / run.layer["trace_steps"])
