"""Trajectory alignment (numpy copy of ``colvo/vo/align.py``).

Umeyama similarity (sim(3)) or rigid (SE(3)) alignment of a predicted
trajectory to ground truth, needed before ATE: monocular VO is
scale-ambiguous."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src→dst.

    Args:
        src, dst: (N, 3) corresponding points (trajectory positions).
        with_scale: solve sim(3) (monocular scale ambiguity) vs SE(3).

    Returns:
        (R (3,3), t (3,), s) minimizing ``Σ‖dst − (s·R·src + t)‖²``
        (Umeyama 1991).
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    rot = u @ s_mat @ vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s_mat) / var_s)
    else:
        scale = 1.0
    t = mu_d - scale * rot @ mu_s
    return rot, t, scale


def align_trajectory(
    pred_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> np.ndarray:
    """Align predicted positions to GT; returns the transformed positions."""
    rot, t, s = umeyama(pred_positions, gt_positions, with_scale)
    return (s * (rot @ pred_positions.T)).T + t


def align_poses(
    pred_poses: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> np.ndarray:
    """Align full (N, 4, 4) pose chain to GT positions; returns transformed
    (N, 4, 4) poses (rotations rotated, translations similarity-mapped)."""
    rot, t, s = umeyama(pred_poses[:, :3, 3], gt_positions, with_scale)
    out = pred_poses.copy().astype(np.float64)
    out[:, :3, 3] = (s * (rot @ pred_poses[:, :3, 3].T)).T + t
    out[:, :3, :3] = rot @ pred_poses[:, :3, :3]
    return out
