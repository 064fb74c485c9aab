"""Geometry core: SE(3) and projective ops in plain PyTorch."""

from colvo_torch.geometry.se3 import (
    axis_angle_to_matrix,
    invert_transform,
    matrix_to_axis_angle,
    renormalize_rotation,
    se3_exp,
    se3_log,
    transformation_from_parameters,
)
from colvo_torch.geometry.ops import (
    backproject,
    bilinear_sample,
    bilinear_taps,
    depth_to_disp,
    disp_to_depth,
    inverse_warp,
    pixel_grid,
    project,
    reproject_depth,
)

__all__ = [
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "se3_exp",
    "se3_log",
    "transformation_from_parameters",
    "invert_transform",
    "renormalize_rotation",
    "disp_to_depth",
    "depth_to_disp",
    "pixel_grid",
    "backproject",
    "project",
    "bilinear_taps",
    "bilinear_sample",
    "inverse_warp",
    "reproject_depth",
]
