"""Pose decoder + DCDP fusion (port of ``colvo/models/posenet.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from colvo_torch.models.encoder import ENCODER_CHANNELS, Conv


class DCDPFusion(nn.Module):
    """Project each frame's /32 depth bottleneck (``depth_channels``, the
    ResNet's 512 by default) to ``features`` channels by a 1×1 conv + ReLU
    and concatenate ``[pose_feat, proj_0, proj_1]`` along channels, cropped
    to the smallest spatial size."""

    def __init__(self, features: int = 64, n_inputs: int = 2,
                 dtype: torch.dtype = torch.float32,
                 depth_channels: int = ENCODER_CHANNELS[-1]):
        super().__init__()
        self.depth_proj = nn.ModuleList(
            Conv(depth_channels, features, 1, dtype=dtype) for _ in range(n_inputs)
        )

    def forward(self, pose_feat: torch.Tensor,
                depth_feats: Sequence[torch.Tensor]) -> torch.Tensor:
        parts = [pose_feat]
        for proj, df in zip(self.depth_proj, depth_feats):
            p = F.relu(proj(df))
            h = min(p.shape[2], pose_feat.shape[2])
            w = min(p.shape[3], pose_feat.shape[3])
            parts.append(p[:, :, :h, :w])
        h = min(p.shape[2] for p in parts)
        w = min(p.shape[3] for p in parts)
        return torch.cat([p[:, :, :h, :w] for p in parts], dim=1)


class PoseDecoder(nn.Module):
    """Bottleneck → (axisangle, translation), each (B, 3): 1×1 squeeze,
    two 3×3 convs with ReLU, a float32 1×1 to 6 channels, spatial mean,
    then the 0.01 scales."""

    def __init__(self, cin: int, rotation_scale: float = 0.01,
                 translation_scale: float = 0.01, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rotation_scale = rotation_scale
        self.translation_scale = translation_scale
        self.squeeze = Conv(cin, 256, 1, dtype=dtype)
        self.pose_0 = Conv(256, 256, 3, dtype=dtype)
        self.pose_1 = Conv(256, 256, 3, dtype=dtype)
        self.pose_2 = Conv(256, 6, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.squeeze(x))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        out = self.pose_2(x.float()).mean(dim=(2, 3))
        return self.rotation_scale * out[:, :3], self.translation_scale * out[:, 3:]
