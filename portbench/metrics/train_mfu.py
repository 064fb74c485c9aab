"""The whole training step's share of the card's bf16 peak: the model's
convolution FLOPs a step (``flops.train_step_flops``, three times the
forward over B·F frames and B·S pairs) over the window's ms a step."""

from portbench import flops


def read(run):
    ms = run.layer.get("step_ms")
    if not ms:
        return None
    return 100.0 * flops.train_step_flops(run.layer["cfg"]) / (ms / 1e3) / run.peaks["bf16_flops_s"]
