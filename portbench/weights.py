"""Random weights of a configuration, drawn on the device from the seed.

One ``torch.randn`` over all convolution kernels from a ``torch.Generator``
on the device, split by the reference's weight list and scaled to
LeCun-normal (std √(1/fan-in)), as the program initialises; GroupNorm
scales 1 and shifts 0. Where the configuration has no normalisation
(BatchNorm folded into the convolutions, as a trained Monodepth2 checkpoint
is imported) the kernels take He-normal (√(2/fan-in)) and the biases a
draw of std 0.01, so that activations neither vanish nor saturate the
disparity heads.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.model import spec


def make(model_cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """{state_dict name: float32 tensor on ``device``}."""
    items = spec(model_cfg)
    folded = model_cfg.norm == "none"
    total = sum(int(np.prod(s)) for _, s in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in items:
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        at += n
        norm_leaf = "norm" in name.rsplit(".", 2)[-2]
        if norm_leaf:
            x = torch.ones(shape, device=device) if name.endswith("weight") else \
                torch.zeros(shape, device=device)
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            x = x * math.sqrt((2.0 if folded else 1.0) / fan_in)
        else:
            x = x * 0.01 if folded else torch.zeros(shape, device=device)
        out[name] = x
    return out
