"""3D reconstruction (numpy copy of ``colvo/vo/recon.py``).

Backprojects each keyframe's depth through its global pose into one world
point cloud, voxel-downsamples it (``colvo_torch/native``) and exports
PLY. All of it runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from colvo_torch import native
from colvo_torch.vo.driver import VOResult


@dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float32, world frame
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]

    def __len__(self) -> int:
        return len(self.points)


def backproject_depth_np(depth: np.ndarray, k_inv: np.ndarray) -> np.ndarray:
    """(H, W) depth → (H·W, 3) cam-frame points."""
    h, w = depth.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    rays = pix @ k_inv.T
    return rays * depth.reshape(-1, 1)


def voxel_downsample(
    points: np.ndarray, voxel: float, colors: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and colors) within voxel cells, through the native
    library; a failed build or load raises. Cells come out in order of
    first appearance."""
    return native.voxel_downsample(points, voxel, colors)


def voxel_downsample_np(
    points: np.ndarray, voxel: float, colors: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The plain numpy version of :func:`voxel_downsample` (a unique-reduce;
    cells come out in order of their packed key)."""
    keys = np.floor(points / voxel).astype(np.int64)
    # pack 3×21-bit signed grid coords into one int64 key
    packed = (
        (keys[:, 0] & 0x1FFFFF) << 42
        | (keys[:, 1] & 0x1FFFFF) << 21
        | (keys[:, 2] & 0x1FFFFF)
    )
    uniq, inv, counts = np.unique(packed, return_inverse=True, return_counts=True)
    acc = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(acc, inv, points)
    out_pts = (acc / counts[:, None]).astype(np.float32)
    out_cols = None
    if colors is not None:
        cacc = np.zeros((len(uniq), 3), dtype=np.float64)
        np.add.at(cacc, inv, colors)
        out_cols = (cacc / counts[:, None]).astype(np.float32)
    return out_pts, out_cols


def stitch_pointclouds(
    vo: VOResult,
    k: np.ndarray,
    frames: Optional[List[np.ndarray]] = None,
    voxel: float = 0.002,
    max_depth: Optional[float] = None,
    stride: int = 2,
    max_depth_rel: Optional[float] = None,
) -> PointCloud:
    """Stitch keyframe depths into one world-frame cloud.

    Args:
        vo: VO result (poses + keyframe depths).
        k: (3, 3) intrinsics.
        frames: optional RGB frames (indexed by keyframe id) for colors.
        voxel: downsample cell size (meters, network scale).
        max_depth: drop points beyond this depth (colon far-wall noise).
        max_depth_rel: like max_depth but in units of each frame's MEDIAN
            depth — invariant to the monocular gauge, so the same cap
            keeps the same near-wall fraction whether the depths are GT
            or sim(3)-rescaled predictions (an absolute cap silently
            empties the cloud when the aligned scale shifts).
        stride: pixel subsampling before stitching (dense depth is
            redundant at cloud level).
    """
    # Striding subsamples the pixel grid: pixel (i, j) of the strided map is
    # pixel (i·stride, j·stride) of the original — fold that into K.
    k_s = k.astype(np.float64).copy()
    k_s[0, :] /= stride
    k_s[1, :] /= stride
    k_inv = np.linalg.inv(k_s)
    all_pts, all_cols = [], []
    for depth, fid in zip(vo.depths, vo.keyframe_ids):
        d = depth[::stride, ::stride]
        pts_cam = backproject_depth_np(d, k_inv)
        valid = np.isfinite(pts_cam).all(axis=1)
        if max_depth is not None:
            valid &= d.reshape(-1) < max_depth
        if max_depth_rel is not None:
            valid &= d.reshape(-1) < max_depth_rel * float(np.median(d))
        pts_cam = pts_cam[valid]
        pose = vo.poses[fid]
        pts_w = pts_cam @ pose[:3, :3].T + pose[:3, 3]
        all_pts.append(pts_w.astype(np.float32))
        if frames is not None:
            fr = np.asarray(frames[fid])
            col = fr[::stride, ::stride].reshape(-1, 3)[valid].astype(np.float32)
            if fr.dtype == np.uint8:  # rgb8 sources
                col = col / 255.0
            all_cols.append(col)
    pts = np.concatenate(all_pts)
    cols = np.concatenate(all_cols) if all_cols else None
    pts, cols = voxel_downsample(pts, voxel, cols)
    return PointCloud(points=pts, colors=cols)


def save_ply(cloud: PointCloud, path: str) -> None:
    """Export an ASCII PLY (colored if colors present)."""
    n = len(cloud)
    has_color = cloud.colors is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            cols = (np.clip(cloud.colors, 0, 1) * 255).astype(np.uint8)
            for p, c in zip(cloud.points, cols):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in cloud.points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_ply(path: str) -> PointCloud:
    """Read back an ASCII PLY written by :func:`save_ply`."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n = 0
        has_color = False
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar red"):
                has_color = True
            if line == "end_header":
                break
        pts = np.zeros((n, 3), dtype=np.float32)
        cols = np.zeros((n, 3), dtype=np.float32) if has_color else None
        for i in range(n):
            vals = f.readline().split()
            pts[i] = [float(v) for v in vals[:3]]
            if has_color:
                cols[i] = [int(v) / 255.0 for v in vals[3:6]]
    return PointCloud(points=pts, colors=cols)
