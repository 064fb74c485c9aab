"""Benchmark-dataset loader for VCD/CSD-style colonoscopy sequences (port
of ``colvo/data/benchmark.py``), without cv2: PNG frames and 16-bit PNG
depth go through ``data/png.py``, JPEG frames through cv2 where it is
installed.

```
<root>/
  <sequence>/
    rgb/  000000.png 000001.png ...        8-bit RGB frames (required)
    depth/ 000000.npy | 000000.png ...     dense GT depth (optional):
                                           .npy float meters, or 16-bit PNG
                                           scaled by depth_scale.txt
    depth_scale.txt                        meters-per-unit for PNG depth
                                           (default 1/65535 ⇒ [0,1] m)
    poses.txt                              GT trajectory (optional): one
                                           line per frame, either 16 or 12
                                           floats (row-major 4×4 / 3×4
                                           cam-to-world, KITTI-style) or
                                           8 floats TUM-style
                                           (t tx ty tz qx qy qz qw)
    intrinsics.txt                         9 floats (3×3 K, at the rgb
                                           resolution) or 4 (fx fy cx cy)
```

Frames and GT are resized to the eval resolution (K rescaled with them,
depth nearest-resampled to keep metric validity masks crisp).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from colvo_torch.data.intrinsics import scale_intrinsics
from colvo_torch.data.png import read_png
from colvo_torch.data.sources import _read_rgb8, _resize, _to_float_rgb


@dataclass
class BenchmarkSequence:
    name: str
    frames: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    k: np.ndarray  # (3, 3) at the loaded resolution
    gt_depths: Optional[np.ndarray] = None  # (N, H, W) float32 meters
    gt_poses: Optional[np.ndarray] = None  # (N, 4, 4) cam-to-world


def list_sequences(root: str) -> List[str]:
    """Subdirectories of ``root`` that contain an ``rgb/`` frame dir."""
    out = []
    for name in sorted(os.listdir(root)):
        if os.path.isdir(os.path.join(root, name, "rgb")):
            out.append(name)
    return out


def _load_intrinsics(path: str, src_wh, dst_wh) -> np.ndarray:
    vals = np.loadtxt(path).reshape(-1)
    if vals.size == 9:
        k = vals.reshape(3, 3).astype(np.float32)
    elif vals.size == 4:
        fx, fy, cx, cy = vals
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    else:
        raise ValueError(f"intrinsics.txt must hold 9 or 4 floats, got {vals.size}")
    return scale_intrinsics(k, dst_wh[0] / src_wh[0], dst_wh[1] / src_wh[1])


def _quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qx, qy, qz, qw], np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _load_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    poses = []
    for r in rows:
        if r.size == 16:
            t = r.reshape(4, 4)
        elif r.size == 12:
            t = np.vstack([r.reshape(3, 4), [0, 0, 0, 1]])
        elif r.size == 8:  # TUM: timestamp tx ty tz qx qy qz qw
            t = np.eye(4)
            t[:3, 3] = r[1:4]
            t[:3, :3] = _quat_to_rot(*r[4:8])
        else:
            raise ValueError(f"poses.txt rows must hold 16/12/8 floats, got {r.size}")
        poses.append(t)
    return np.stack(poses).astype(np.float64)


def _nearest_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    output index d reads source ``min(floor(d · (1 / (dst / src))), src − 1)``
    along each axis."""
    h, w = img.shape[:2]

    def index(src: int, dst: int) -> np.ndarray:
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64),
                          src - 1)

    return img[index(h, height)[:, None], index(w, width)[None, :]]


def load_benchmark_sequence(
    seq_dir: str, width: int, height: int
) -> BenchmarkSequence:
    """Load one benchmark sequence at the eval resolution (layout above)."""
    rgb_dir = os.path.join(seq_dir, "rgb")
    files = sorted(
        f for f in os.listdir(rgb_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not files:
        raise FileNotFoundError(f"no frames in {rgb_dir}")
    frames = []
    src_wh = None
    for f in files:
        rgb = _read_rgb8(os.path.join(rgb_dir, f))
        src_wh = (rgb.shape[1], rgb.shape[0])
        frames.append(_to_float_rgb(_resize(rgb, width, height)))
    frames = np.stack(frames)

    k_path = os.path.join(seq_dir, "intrinsics.txt")
    if not os.path.exists(k_path):
        raise FileNotFoundError(k_path)
    k = _load_intrinsics(k_path, src_wh, (width, height))

    gt_depths = None
    depth_dir = os.path.join(seq_dir, "depth")
    if os.path.isdir(depth_dir):
        scale_path = os.path.join(seq_dir, "depth_scale.txt")
        png_scale = (
            float(np.loadtxt(scale_path)) if os.path.exists(scale_path)
            else 1.0 / 65535.0
        )
        # Depth↔frame pairing is by basename stem, not sort order: a stray
        # or missing depth file with a coincidentally matching count would
        # silently misalign every frame against its GT otherwise.
        depth_by_stem = {}
        for f in os.listdir(depth_dir):
            stem, ext = os.path.splitext(f)
            if ext.lower() in (".npy", ".png"):
                depth_by_stem[stem] = f
        if depth_by_stem:
            depths = []
            for rgb_f in files:
                stem = os.path.splitext(rgb_f)[0]
                f = depth_by_stem.get(stem)
                if f is None:
                    raise FileNotFoundError(
                        f"{depth_dir}: no GT depth named '{stem}.*' for frame "
                        f"{rgb_f} (depths are matched to frames by stem)"
                    )
                p = os.path.join(depth_dir, f)
                if f.endswith(".npy"):
                    d = np.load(p).astype(np.float32)
                else:
                    raw = read_png(p)
                    if raw.ndim == 3:  # an 8-bit file: its gray channel
                        raw = raw[..., 0]
                    d = raw.astype(np.float32) * png_scale
                depths.append(_nearest_resize(d, width, height))
            gt_depths = np.stack(depths)

    gt_poses = None
    pose_path = os.path.join(seq_dir, "poses.txt")
    if os.path.exists(pose_path):
        gt_poses = _load_poses(pose_path)
        if len(gt_poses) != len(frames):
            raise ValueError(
                f"{seq_dir}: {len(gt_poses)} poses vs {len(frames)} frames"
            )

    return BenchmarkSequence(
        name=os.path.basename(seq_dir.rstrip("/")),
        frames=frames,
        k=k,
        gt_depths=gt_depths,
        gt_poses=gt_poses,
    )
