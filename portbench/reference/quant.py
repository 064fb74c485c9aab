"""The control: the reference one precision below the configuration's.

The configuration computes its convolutions in bfloat16, so the control
rounds both operands of every convolution to float8 (e4m3, one scale a
tensor from its largest magnitude, as float8 training scales), keeps the
arithmetic in float32 and passes the gradient straight through the
rounding. ``check`` requires that the control fails one of a cell's
compared numbers.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, as float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach()) if x.requires_grad else q
