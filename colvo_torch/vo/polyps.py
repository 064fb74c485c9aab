"""Polyp localisation (numpy copy of ``colvo/vo/polyps.py``).

Lifts 2D polyp detections (boxes from an upstream detector, which is out
of the VO system's scope) into the world frame through depth and pose, and
reports the localisation error ``e`` against ground-truth 3D positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from colvo_torch.vo.driver import VOResult


@dataclass
class PolypDetection:
    """A 2D detection in a given frame: box in pixels (x0, y0, x1, y1)."""

    frame_id: int
    box: Tuple[float, float, float, float]
    score: float = 1.0


@dataclass
class PolypLocalization:
    detection: PolypDetection
    position_world: np.ndarray  # (3,)
    error: Optional[float] = None  # ‖pred − gt‖ when GT given


def _box_depth(depth: np.ndarray, box, percentile: float = 30.0) -> Tuple[float, float, float]:
    """Robust polyp depth + center: median-ish depth inside the box.

    Polyps protrude toward the camera, so a low percentile of the box's
    depth distribution picks the polyp surface rather than the wall behind.
    Returns (cx, cy, d).
    """
    x0, y0, x1, y1 = [int(round(v)) for v in box]
    h, w = depth.shape
    x0, x1 = np.clip([x0, x1], 0, w - 1)
    y0, y1 = np.clip([y0, y1], 0, h - 1)
    patch = depth[y0 : y1 + 1, x0 : x1 + 1]
    d = float(np.percentile(patch, percentile))
    return (0.5 * (x0 + x1), 0.5 * (y0 + y1), d)


def localize_polyps(
    vo: VOResult,
    k: np.ndarray,
    detections: Sequence[PolypDetection],
    gt_positions: Optional[np.ndarray] = None,
) -> List[PolypLocalization]:
    """Lift 2D detections into world coordinates along the trajectory.

    Args:
        vo: VO result — must contain the depth map of each detection's
            frame (run with ``keyframe_every=1`` for arbitrary frames).
        k: (3, 3) intrinsics.
        detections: 2D polyp detections.
        gt_positions: optional (P, 3) GT polyp positions (same order as
            detections) → fills the per-polyp error ``e``.
    """
    k_inv = np.linalg.inv(k.astype(np.float64))
    kf_index = {fid: i for i, fid in enumerate(vo.keyframe_ids)}
    out: List[PolypLocalization] = []
    for det_idx, det in enumerate(detections):
        if det.frame_id not in kf_index:
            raise KeyError(
                f"no stored depth for frame {det.frame_id}; "
                "run VO with keyframe_every=1"
            )
        depth = vo.depths[kf_index[det.frame_id]]
        cx, cy, d = _box_depth(depth, det.box)
        p_cam = k_inv @ np.array([cx, cy, 1.0]) * d
        pose = vo.poses[det.frame_id]
        p_world = pose[:3, :3] @ p_cam + pose[:3, 3]
        err = None
        if gt_positions is not None:
            err = float(np.linalg.norm(p_world - gt_positions[det_idx]))
        out.append(PolypLocalization(det, p_world.astype(np.float64), err))
    return out
