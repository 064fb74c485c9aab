"""Loss suite: LCC + SSIM/L1, automask, smoothness, geometric consistency."""

from colvo_torch.losses.photometric import lcc_calibrate, photometric_error, ssim
from colvo_torch.losses.terms import (
    automask,
    geometry_consistency,
    min_reprojection,
    smoothness_loss,
)
from colvo_torch.losses.total import poses_to_transforms, snippet_loss

__all__ = [
    "ssim",
    "photometric_error",
    "lcc_calibrate",
    "smoothness_loss",
    "geometry_consistency",
    "min_reprojection",
    "automask",
    "snippet_loss",
    "poses_to_transforms",
]
