"""A training step on an MPViT depth net as a share of the card's bf16
peak: its FLOPs (``flops_mpvit.train_step_flops``: the encoder's GEMMs and
convolutions, factorized attention's two products, the U-Net decoder and
the pose net, a backward twice its forward) over the window's ms a step."""

from portbench import flops_mpvit


def read(run):
    ms = run.layer.get("step_ms")
    if not ms:
        return None
    return (100.0 * flops_mpvit.train_step_flops(run.layer["cfg"]) / (ms / 1e3)
            / run.peaks["bf16_flops_s"])
