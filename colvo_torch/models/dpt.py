"""Depth Anything V2's depth network: the DINOv2 encoder (``models/vit.py``)
and the DPT head (Ranftl et al., arXiv:2103.13413, as
``depth_anything_v2/dpt.py`` writes it, ``use_bn=False``,
``use_clstoken=False``).

The head takes four taps of the encoder as patch-grid maps: 1×1
projections to ``out_channels``, resized by a 4×4/s4 and a 2×2/s2
transposed conv, identity and a 3×3/s2 conv (to 4×, 2×, 1× and ½× the
grid); 3×3 convs without bias to ``features`` (``scratch.layer*_rn``);
four FeatureFusionBlocks from the coarsest up (residual conv units of
ReLU, 3×3, ReLU, 3×3 and the input; bilinear ``align_corners=True``
upsampling to the next tap's size, ×2 at the last; a 1×1 ``out_conv``);
``output_conv1`` (3×3 to ``features // 2``), a bilinear upsample to the
input size, then 3×3 to 32, ReLU and 1×1 to 1.

Two departures from DA-V2, which predicts relative depth:

* the last ReLU is a sigmoid, computed in float32 after a float32 1×1
  conv, so that the head gives the (0, 1) disparity that
  ``disp_to_depth`` and the loss take, as the ResNet decoder's heads do;
* a frame whose side is not a multiple of 14 is resized bilinearly to the
  nearest multiple (``vit.grid_size``) before the encoder, and the head
  upsamples straight to the frame's own H × W, as DA-V2's pipeline
  resizes its input to ``ensure_multiple_of=14``. At multiples of 14
  nothing is resized and the published path is exact.

Frames are ImageNet-normalised inside the network (the loss and the pose
net take the [0, 1] frames). Convs compute in ``model.dtype`` with float32
parameters (LeCun-normal, as ``Conv``); module names are DA-V2's, less the
modules its forward never calls (``mask_token``,
``refinenet4.resConfUnit1``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from colvo_torch.config import ModelConfig
from colvo_torch.models.encoder import _TRUNC_STD, Conv
from colvo_torch.models.vit import PATCH, ViTEncoder, grid_size, preset

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvTranspose(nn.Module):
    """k×k transposed conv of stride k computing in ``dtype``; LeCun-normal
    over a fan-in of cin·k·k (Flax's ``ConvTranspose`` convention), bias 0."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        cin, _, k, _ = self.weight.shape
        std = math.sqrt(1.0 / (cin * k * k)) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=self.weight.shape[-1])


def _conv3(cin: int, cout: int, dtype: torch.dtype, bias: bool = True, stride: int = 1) -> Conv:
    return Conv(cin, cout, 3, stride, bias=bias, dtype=dtype, padding=1)


def _conv1(cin: int, cout: int, dtype: torch.dtype) -> Conv:
    return Conv(cin, cout, 1, bias=True, dtype=dtype, padding=0)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _conv3(features, features, dtype)
        self.conv2 = _conv3(features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """(path, skip) → upsampled path: ``path + RCU₁(skip)`` (no skip at the
    coarsest block), RCU₂, bilinear to ``size`` (×2 without one), 1×1."""

    def __init__(self, features: int, dtype: torch.dtype, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = _conv1(features, features, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None,
                size: Sequence[int] | None = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, size=size, scale_factor=None if size else 2, mode="bilinear",
                          align_corners=True)
        return self.out_conv(x)


class DPTHead(nn.Module):
    def __init__(self, dim: int, features: int, out_channels: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        c = tuple(out_channels)
        self.projects = nn.ModuleList(_conv1(dim, ci, dtype) for ci in c)
        self.resize_layers = nn.ModuleList([ConvTranspose(c[0], c[0], 4, dtype),
                                            ConvTranspose(c[1], c[1], 2, dtype), nn.Identity(),
                                            _conv3(c[3], c[3], dtype, stride=2)])
        self.scratch = nn.Module()
        for i, ci in enumerate(c, start=1):
            setattr(self.scratch, f"layer{i}_rn", _conv3(ci, features, dtype, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusionBlock(features, dtype, i < 4))
        self.scratch.output_conv1 = _conv3(features, features // 2, dtype)
        self.scratch.output_conv2 = nn.Sequential(
            _conv3(features // 2, 32, dtype), nn.ReLU(), _conv1(32, 1, torch.float32))

    def forward(self, taps: List[torch.Tensor], gh: int, gw: int,
                size: Tuple[int, int]) -> torch.Tensor:
        """The taps' (B, gh·gw, dim) tokens → disparity (B, 1, *size) in (0, 1)."""
        s = self.scratch
        layers = []
        for i, t in enumerate(taps):
            x = t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw)
            x = self.resize_layers[i](self.projects[i](x))
            layers.append(getattr(s, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = layers
        path = s.refinenet4(l4, size=l3.shape[2:])
        path = s.refinenet3(path, l3, size=l2.shape[2:])
        path = s.refinenet2(path, l2, size=l1.shape[2:])
        path = s.refinenet1(path, l1)
        out = F.interpolate(s.output_conv1(path), size=size, mode="bilinear", align_corners=True)
        return torch.sigmoid(s.output_conv2(out))


class DPTDepthNet(nn.Module):
    """Single-frame depth on Depth Anything V2: NCHW image in [0, 1] →
    ({0: disp (B, 1, H, W)}, the last tap's (B, gh·gw, dim) tokens, which
    stand where the ResNet's /32 bottleneck does for the stream and the
    serving programs)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        p = preset(cfg.depth_net)
        if cfg.n_scales != 1:
            raise ValueError(f"model.depth_net={cfg.depth_net!r} gives one full-resolution "
                             f"disparity: model.n_scales must be 1, not {cfg.n_scales}")
        if cfg.dcdp_fusion:
            raise ValueError(f"model.depth_net={cfg.depth_net!r} has no /32 ResNet bottleneck "
                             "to fuse: model.dcdp_fusion must be false")
        self.pretrained = ViTEncoder(p["dim"], p["depth"], p["heads"], p["taps"], dtype,
                                     cfg.remat)
        self.depth_head = DPTHead(p["dim"], p["features"], p["out_channels"], dtype)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, img: torch.Tensor) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        h, w = img.shape[2], img.shape[3]
        gh, gw = grid_size(h), grid_size(w)
        x = (img.float() - self.mean) / self.std
        if (gh * PATCH, gw * PATCH) != (h, w):
            x = F.interpolate(x, size=(gh * PATCH, gw * PATCH), mode="bilinear",
                              align_corners=False)
        taps = self.pretrained(x)
        return {0: self.depth_head(taps, gh, gw, (h, w))}, taps[-1]
