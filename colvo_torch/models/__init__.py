"""DepthNet / PoseNet / DCDP fusion in PyTorch (NCHW inside)."""

from colvo_torch.models.depth_decoder import DepthDecoder, upsample_nearest
from colvo_torch.models.depthnet import ColVOModel, DepthNet, compute_dtype
from colvo_torch.models.encoder import ResNetEncoder
from colvo_torch.models.posenet import DCDPFusion, PoseDecoder

__all__ = [
    "ColVOModel",
    "DepthNet",
    "DepthDecoder",
    "ResNetEncoder",
    "DCDPFusion",
    "PoseDecoder",
    "compute_dtype",
    "upsample_nearest",
]
