"""Depth decoder (port of ``colvo/models/depth_decoder.py``).

U-Net decoder with skips concatenated as ``[x, skip]``; ELU, nearest ×2
upsampling and 3×3 convs; sigmoid disparity heads at ``n_scales`` scales,
computed in float32; with ``remat`` each ``ConvBlock`` is recomputed in the
backward. ``channels`` are the encoder pyramid's five widths, /2 to /32
(the ResNet's by default). ``pad_mode`` "same" (default) pads the convs as
Flax ``SAME`` does; "reflect" (selected by ``model.norm="none"``, the
family's ``Conv3x3``) reflects the input by one pixel and convolves without
padding.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from colvo_torch.models.encoder import ENCODER_CHANNELS, Conv, remat_call

DECODER_CHANNELS = (16, 32, 64, 128, 256)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×factor upsample of an NHWC map."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


class Conv3x3(Conv):
    """3×3 conv with a bias, padded as ``pad_mode`` says."""

    def __init__(self, cin: int, cout: int, pad_mode: str, dtype: torch.dtype):
        if pad_mode not in ("same", "reflect"):
            raise ValueError(f"pad_mode must be 'same' or 'reflect', not {pad_mode!r}")
        super().__init__(cin, cout, 3, dtype=dtype, padding=0 if pad_mode == "reflect" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        return super().forward(x)


class ConvBlock(nn.Module):
    """3×3 conv + ELU."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype, pad_mode: str = "same"):
        super().__init__()
        self.conv = Conv3x3(cin, cout, pad_mode, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """5-scale encoder pyramid → ``{scale: disp}`` with disp NCHW
    (B, 1, H/2^s, W/2^s) in (0, 1) for s in 0..n_scales−1."""

    def __init__(self, n_scales: int = 4, dtype: torch.dtype = torch.float32,
                 pad_mode: str = "same", remat: bool = False,
                 channels: Sequence[int] = ENCODER_CHANNELS):
        super().__init__()
        self.n_scales = n_scales
        self.remat = remat
        blocks = []
        cin = channels[-1]
        for i in range(4, -1, -1):
            blocks.append(ConvBlock(cin, DECODER_CHANNELS[i], dtype, pad_mode))
            cin = DECODER_CHANNELS[i] + (channels[i - 1] if i > 0 else 0)
            blocks.append(ConvBlock(cin, DECODER_CHANNELS[i], dtype, pad_mode))
            cin = DECODER_CHANNELS[i]
        self.blocks = nn.ModuleList(blocks)
        self.dispconvs = nn.ModuleList(
            Conv3x3(DECODER_CHANNELS[i], 1, pad_mode, torch.float32) for i in range(n_scales)
        )

    def _block(self, j: int, x: torch.Tensor) -> torch.Tensor:
        return remat_call(self.blocks[j], x) if self.remat else self.blocks[j](x)

    def forward(self, enc_features: Sequence[torch.Tensor]) -> Dict[int, torch.Tensor]:
        outputs: Dict[int, torch.Tensor] = {}
        x = enc_features[-1]
        for level, i in enumerate(range(4, -1, -1)):
            x = self._block(2 * level, x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, enc_features[i - 1].to(x.dtype)], dim=1)
            x = self._block(2 * level + 1, x)
            if i < self.n_scales:
                outputs[i] = torch.sigmoid(self.dispconvs[i](x.float()))
        return outputs
