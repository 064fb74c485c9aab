"""Depth and pose evaluation and the reference's figures (port of
``colvo/evaluation``; the figures are drawn by the port's own numpy
rasterizer: nothing here imports a plotting library)."""

from colvo_torch.evaluation.depth import (
    DEPTH_METRIC_NAMES,
    compute_depth_errors,
    evaluate_depth,
    signed_error_map,
)
from colvo_torch.evaluation.pose import ate, evaluate_pose, rpe
from colvo_torch.evaluation.viz import (
    colormap_depth,
    viz_depth_grid,
    viz_recon,
    viz_recon_pair,
    viz_trajectory,
)

__all__ = [
    "DEPTH_METRIC_NAMES",
    "compute_depth_errors",
    "signed_error_map",
    "evaluate_depth",
    "ate",
    "rpe",
    "evaluate_pose",
    "colormap_depth",
    "viz_trajectory",
    "viz_depth_grid",
    "viz_recon",
    "viz_recon_pair",
]
