"""A training step on a DPT depth net as a share of the card's bf16 peak:
its FLOPs (``flops_dpt.train_step_flops``: the ViT's GEMMs, attention's
4·N²·d forward and 10·N²·d backward, the DPT head's convolutions and the
pose net, other backwards twice their forward) over the window's ms a
step."""

from portbench import flops_dpt


def read(run):
    ms = run.layer.get("step_ms")
    if not ms:
        return None
    return (100.0 * flops_dpt.train_step_flops(run.layer["cfg"]) / (ms / 1e3)
            / run.peaks["bf16_flops_s"])
