"""Depth and pose evaluation (port of ``colvo/evaluation``, without its
figures: nothing here imports a plotting library)."""

from colvo_torch.evaluation.depth import (
    DEPTH_METRIC_NAMES,
    compute_depth_errors,
    evaluate_depth,
    signed_error_map,
)
from colvo_torch.evaluation.pose import ate, evaluate_pose, rpe

__all__ = [
    "DEPTH_METRIC_NAMES",
    "compute_depth_errors",
    "signed_error_map",
    "evaluate_depth",
    "ate",
    "rpe",
    "evaluate_pose",
]
