"""Pose and trajectory evaluation (numpy copy of
``colvo/evaluation/pose.py``): ATE after Umeyama alignment, and RPE over
fixed frame gaps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from colvo_torch.vo.align import align_trajectory, umeyama


def ate(
    pred_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> float:
    """RMSE of position error after sim(3)/SE(3) alignment."""
    aligned = align_trajectory(pred_positions, gt_positions, with_scale)
    return float(np.sqrt(np.mean(np.sum((aligned - gt_positions) ** 2, axis=1))))


def rpe(
    pred_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> Dict[str, float]:
    """Relative pose error over frame gaps of ``delta``.

    Returns translational RMSE (same units as GT) and rotational RMSE.
    Rotation convention: per-pair geodesic angle in RADIANS internally;
    the reported ``rpe_rot_deg`` is the RMS of those angles converted to
    DEGREES (TUM rpe tool convention). Scale-aligns the translation
    magnitudes first (monocular).
    """
    n = min(len(pred_poses), len(gt_poses)) - delta
    t_errs, r_errs = [], []
    # global scale from trajectories
    _, _, scale = umeyama(pred_poses[: n + delta, :3, 3], gt_poses[: n + delta, :3, 3])
    for i in range(n):
        dp = np.linalg.inv(pred_poses[i]) @ pred_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        dt = scale * dp[:3, 3] - dg[:3, 3]
        t_errs.append(np.sum(dt**2))
        dr = dp[:3, :3].T @ dg[:3, :3]
        angle = np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))
        r_errs.append(angle**2)
    return {
        "rpe_trans": float(np.sqrt(np.mean(t_errs))),
        "rpe_rot_deg": float(np.degrees(np.sqrt(np.mean(r_errs)))),
    }


def evaluate_pose(
    pred_poses: np.ndarray, gt_poses: np.ndarray, with_scale: bool = True
) -> Dict[str, float]:
    """Full pose evaluation: ATE + RPE(1) + RPE(5)."""
    out = {"ate": ate(pred_poses[:, :3, 3], gt_poses[: len(pred_poses), :3, 3], with_scale)}
    out.update(rpe(pred_poses, gt_poses, delta=1))
    if len(pred_poses) > 6:
        r5 = rpe(pred_poses, gt_poses, delta=5)
        out["rpe_trans_5"] = r5["rpe_trans"]
        out["rpe_rot_deg_5"] = r5["rpe_rot_deg"]
    return out
