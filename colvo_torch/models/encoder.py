"""Convolutional encoder (port of ``colvo/models/encoder.py``).

ResNet-18/34 feature pyramid, NCHW, in the JAX package's two geometries,
keyed on ``norm``:

* ``"group"`` (default): XLA ``SAME`` padding, which on even inputs pads
  strided convs asymmetrically ((2, 3) for the 7×7/s2 stem, (0, 1) for
  3×3/s2, none for 1×1/s2) and so needs an explicit ``F.pad``; bias-free
  convs, each followed by GroupNorm with ``groups = min(max(8, C // 16),
  C)`` and Flax's eps 1e-6.
* ``"none"`` (the target of a family checkpoint's import, BatchNorm folded
  into the convs): convs with a bias, no norm, and torch's symmetric
  padding: 3 for the 7×7 stem, 1 for 3×3 convs, 0 for 1×1.

A 3×3/s2 max-pool padded by one at −inf follows the stem in both. Convs
compute in ``dtype`` (bf16 on the card) with float32 parameters,
initialised like Flax (lecun-normal, truncated).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
ENCODER_CHANNELS: Tuple[int, ...] = (64, 64, 128, 256, 512)

# Flax's truncated-normal lecun init divides the std by this constant so
# that the truncated distribution keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D conv computing in ``dtype``, with Flax ``SAME`` padding, or with
    ``padding`` on every side where it is given."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 padding: int | None = None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        std = math.sqrt(1.0 / self.weight[0].numel()) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.padding is not None:
            return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, self.padding)
        k = self.weight.shape[-1]
        ph = _same_pads(x.shape[2], k, self.stride)
        pw = _same_pads(x.shape[3], k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, padding)


class GroupNorm(nn.GroupNorm):
    """Flax ``GroupNorm`` defaults: 16 channels a group (at least 8
    groups), eps 1e-6, statistics in float32, output in the input dtype."""

    def __init__(self, channels: int):
        super().__init__(min(max(8, channels // 16), channels), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _norm(norm: str, channels: int) -> nn.Module:
    if norm == "group":
        return GroupNorm(channels)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"model.norm must be 'group' or 'none', not {norm!r}")


def _conv(norm: str, cin: int, cout: int, k: int, stride: int, dtype: torch.dtype) -> Conv:
    """A conv of the ``norm`` geometry: bias-free with SAME padding before
    a GroupNorm, or with a bias and torch's padding ``k // 2``."""
    if norm == "none":
        return Conv(cin, cout, k, stride, bias=True, dtype=dtype, padding=k // 2)
    return Conv(cin, cout, k, stride, bias=False, dtype=dtype)


class BasicBlock(nn.Module):
    """Two 3×3 convs + residual, the ResNet-18/34 block."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype,
                 norm: str = "group"):
        super().__init__()
        self.conv1 = _conv(norm, cin, cout, 3, stride, dtype)
        self.norm1 = _norm(norm, cout)
        self.conv2 = _conv(norm, cout, cout, 3, 1, dtype)
        self.norm2 = _norm(norm, cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = _conv(norm, cin, cout, 1, stride, dtype)
            self.down_norm = _norm(norm, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x if self.down is None else self.down_norm(self.down(x))
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """5-scale feature pyramid: features at /2, /4, /8, /16, /32 for
    3-channel frames (DepthNet) or 6-channel frame pairs (PoseNet)."""

    def __init__(self, num_layers: int = 18, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, norm: str = "group"):
        super().__init__()
        if num_layers not in _STAGES:
            raise ValueError(f"num_layers must be one of {sorted(_STAGES)}")
        self.dtype = dtype
        self.stem = _conv(norm, in_channels, 64, 7, 2, dtype)
        self.stem_norm = _norm(norm, 64)
        blocks = []
        cin = 64
        for stage_idx, (n_blocks, width) in enumerate(
            zip(_STAGES[num_layers], ENCODER_CHANNELS[1:])
        ):
            for block_idx in range(n_blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                blocks.append(BasicBlock(cin, width, stride, dtype, norm))
                cin = width
        self.blocks = nn.ModuleList(blocks)
        self._stage_ends = tuple(
            sum(_STAGES[num_layers][: i + 1]) - 1 for i in range(4)
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem_norm(self.stem(x.to(self.dtype))))
        features = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self._stage_ends:
                features.append(x)
        return features
