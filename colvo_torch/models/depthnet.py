"""DepthNet and the coupled ColVO snippet model (port of
``colvo/models/depthnet.py``).

``model.depth_net`` chooses the depth network (``build_depth_net``):
``"resnet"``, the reference's ResNet encoder and Monodepth2 decoder
(``DepthNet``), or a Depth Anything V2 preset (``"dpt_vitl14"``, ...:
``models/dpt.py``), which gives one full-resolution disparity and leaves
``model.num_layers`` and ``model.norm`` to the pose encoder, or MPViT
(``"mpvit_s"``: ``models/mpvit.py``), whose five-level pyramid feeds the
same decoder at every scale and whose /32 feature DCDP fuses; its
BatchNorm trains on the batched depth pass's statistics, so
``model.batched_snippet=false`` normalises each frame's pass on its own.

``model.remat`` recomputes every encoder ``BasicBlock`` and decoder
``ConvBlock`` in the backward pass (``torch.utils.checkpoint``); the
``state_dict`` keys do not change with it. ``model.batched_snippet=false``
runs the reference's per-frame forward: one depth pass a frame and one
pose pass a pair, the same function as the batched passes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from colvo_torch.config import ModelConfig
from colvo_torch.models.depth_decoder import DepthDecoder
from colvo_torch.models.dpt import ConvTranspose, DPTDepthNet
from colvo_torch.models.encoder import ENCODER_CHANNELS, Conv, ResNetEncoder
from colvo_torch.models.mpvit import PRESETS as MPVIT_PRESETS
from colvo_torch.models.mpvit import MPViTDepthNet
from colvo_torch.models.posenet import DCDPFusion, PoseDecoder
from colvo_torch.models.vit import LayerScale, Linear, ViTEncoder


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class DepthNet(nn.Module):
    """Single-frame depth: NCHW image → ({scale: disp (B, 1, h, w)},
    /32 bottleneck used by DCDP fusion)."""

    channels = ENCODER_CHANNELS

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.encoder = ResNetEncoder(cfg.num_layers, 3, dt, cfg.norm, cfg.remat)
        # the import variant mirrors the family's reflection-padded decoder
        self.decoder = DepthDecoder(cfg.n_scales, dt, "reflect" if cfg.norm == "none" else "same",
                                    cfg.remat)

    def forward(self, img: torch.Tensor) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        feats = self.encoder(img)
        return self.decoder(feats), feats[-1]


def build_depth_net(cfg: ModelConfig) -> nn.Module:
    """The depth network ``model.depth_net`` names."""
    if cfg.depth_net == "resnet":
        return DepthNet(cfg)
    if cfg.depth_net in MPVIT_PRESETS:
        return MPViTDepthNet(cfg, compute_dtype(cfg))
    return DPTDepthNet(cfg, compute_dtype(cfg))


class ColVOModel(nn.Module):
    """Coupled depth+pose over a snippet — the DCDP forward.

    ``frames`` (B, n_frames, H, W, 3), index 0 = target. Returns
    ``disps``, a list over frames of {scale: (B, h, w, 1)}, and ``poses``
    (B, n_sources, 6) raw (axisangle, translation) parameters.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.depth = build_depth_net(cfg)
        self.pose_encoder = ResNetEncoder(cfg.num_layers, 6, dt, cfg.norm, cfg.remat)
        cin = ENCODER_CHANNELS[-1]
        self.fusion = None
        if cfg.dcdp_fusion:
            self.fusion = DCDPFusion(cfg.fusion_channels, 2, dt, self.depth.channels[-1])
            cin += 2 * cfg.fusion_channels
        self.pose_decoder = PoseDecoder(
            cin, cfg.pose_rotation_scale, cfg.pose_translation_scale, dt
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax-like init from ``generator``: conv kernels lecun-normal
        (fan-in, truncated), biases 0, GroupNorm scale 1 and bias 0; in a
        DPT depth net also linear layers trunc-normal of std 0.02 with
        biases 0, LayerNorm 1 and 0, LayerScale 1.0, the position table
        trunc-normal of std 0.02 and the cls token of std 1e-6; in an MPViT
        depth net linear layers as the DPT's, BatchNorm 1 and 0 with fresh
        running statistics."""
        for m in self.modules():
            if isinstance(m, (Conv, ConvTranspose, Linear, ViTEncoder)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerScale):
                nn.init.ones_(m.gamma)

    def pose(self, img_a: torch.Tensor, img_b: torch.Tensor,
             depth_feats: Sequence[torch.Tensor] | None):
        """NCHW frame pair (+ their bottlenecks) → (axisangle, translation)."""
        feats = self.pose_encoder(torch.cat([img_a, img_b], dim=1))
        bottleneck = feats[-1]
        if self.fusion is not None and depth_feats is not None:
            bottleneck = self.fusion(bottleneck, depth_feats)
        return self.pose_decoder(bottleneck)

    def forward(self, frames: torch.Tensor):
        if not self.cfg.batched_snippet:
            return self._forward_per_frame(frames)
        b, n_frames, h, w, c = frames.shape
        # One batched depth pass over all snippet frames (GroupNorm is
        # per-sample, so batching is exact).
        x = frames.reshape(b * n_frames, h, w, c).permute(0, 3, 1, 2)
        x = x.to(compute_dtype(self.cfg)).contiguous()
        d_flat, bneck = self.depth(x)
        disps: List[Dict[int, torch.Tensor]] = [
            {
                s: v.reshape(b, n_frames, *v.shape[1:])[:, i].permute(0, 2, 3, 1)
                for s, v in d_flat.items()
            }
            for i in range(n_frames)
        ]
        bneck = bneck.reshape(b, n_frames, *bneck.shape[1:])

        # One batched pose pass over all (target, source) pairs, s-major.
        n_sources = n_frames - 1
        x = x.reshape(b, n_frames, *x.shape[1:])
        img_a = torch.cat([x[:, 0]] * n_sources, dim=0)
        img_b = torch.cat([x[:, s] for s in range(1, n_frames)], dim=0)
        feats = None
        if self.fusion is not None:
            feats = [
                torch.cat([bneck[:, 0]] * n_sources, dim=0),
                torch.cat([bneck[:, s] for s in range(1, n_frames)], dim=0),
            ]
        aa, tr = self.pose(img_a, img_b, feats)
        pose6 = torch.cat([aa, tr], dim=-1)  # (S·B, 6)
        poses = pose6.reshape(n_sources, b, 6).transpose(0, 1)
        return disps, poses

    def _forward_per_frame(self, frames: torch.Tensor):
        """One DepthNet call a snippet frame and one pose call a (target,
        source) pair (``model.batched_snippet=false``), as the reference's
        ``_call_per_frame``: the same function as the batched passes."""
        n_frames = frames.shape[1]
        x = frames.permute(0, 1, 4, 2, 3).to(compute_dtype(self.cfg))
        disps, bottlenecks = [], []
        for i in range(n_frames):
            d, bn = self.depth(x[:, i].contiguous())
            disps.append({s: v.permute(0, 2, 3, 1) for s, v in d.items()})
            bottlenecks.append(bn)
        poses = []
        for s in range(1, n_frames):
            feats = [bottlenecks[0], bottlenecks[s]] if self.fusion is not None else None
            aa, tr = self.pose(x[:, 0], x[:, s], feats)
            poses.append(torch.cat([aa, tr], dim=-1))
        return disps, torch.stack(poses, dim=1)
