"""The attention kernels against their compute bound: the attention calls
of a step (the ``attn/fwd`` launch counter around one steady step,
``layer["attn_calls"]``) times a call's forward and backward FLOPs
(``flops_dpt.attention_call_flops``: 4·N²·d and 10·N²·d over the step's
B·F frames; a backward a call, as without ``model.remat``), at the bf16
peak, over ``attention_ms.dpt``'s device time a step."""

from portbench import flops_dpt


def read(run):
    t, calls = run.trace, run.layer.get("attn_calls")
    if t is None or not calls:
        return None
    spent, _ = t.kernel_s(lambda name: flops_dpt.kernel_kind(name) == "attention")
    if spent <= 0:
        return None
    fwd, bwd = flops_dpt.attention_call_flops(run.layer["cfg"])
    bound = calls * (fwd + bwd) / run.peaks["bf16_flops_s"]
    return 100.0 * bound / (spent / run.layer["trace_steps"])
