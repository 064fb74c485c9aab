"""Synthetic colon renderer (numpy-only copy of ``colvo/data/synthetic.py``).

A procedurally textured cylinder traversed by a known camera trajectory,
with a headlight whose falloff changes surface brightness between frames;
every frame comes with exact depth and pose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def _hash2(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic uint32 lattice hash → [0, 1) floats."""
    seed_term = np.uint32((seed * 2246822519) & 0xFFFFFFFF)
    h = (ix.astype(np.uint32) * np.uint32(374761393)
         + iy.astype(np.uint32) * np.uint32(668265263)
         + seed_term)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(1274126177)
    h ^= h >> np.uint32(16)
    return (h & np.uint32(0xFFFFFF)).astype(np.float32) / float(0x1000000)


def _value_noise(x: np.ndarray, y: np.ndarray, seed: int) -> np.ndarray:
    """Bilinear value noise on a unit lattice (smoothstep-interpolated)."""
    ix, iy = np.floor(x), np.floor(y)
    fx, fy = x - ix, y - iy
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy


def colon_texture(theta: np.ndarray, z: np.ndarray, seed: int = 7) -> np.ndarray:
    """Procedural mucosa albedo at cylinder coords (θ, z) → (..., 3) RGB.

    Multi-octave value noise (tissue mottling) + a vascular sinus pattern +
    haustral ring darkening, in colon-like reddish tones.

    Spatial frequencies are set so the finest octave is a few pixels at
    render scale: self-supervised warping losses only see texture that
    actually changes under an ~10 px reprojection, so a too-smooth wall
    leaves the photometric loss flat at the identity warp (measured: the
    GT warp scored *worse* than identity before LCC with the original
    low-frequency texture — no trainable signal)."""
    u = theta * 6.0
    v = z * 60.0  # z is meters; visible span per frame is ~0.1 m
    n = np.zeros_like(u)
    amp, freq = 1.0, 1.0
    norm = 0.0
    for octave in range(5):
        n += amp * _value_noise(u * freq, v * freq, seed + octave)
        norm += amp
        amp *= 0.55
        freq *= 2.1
    n /= norm
    vessels = 0.22 * np.sin(9.0 * theta + 110.0 * z + 5.0 * n) ** 8
    rings = 0.15 * np.cos(2 * np.pi * z / 0.08) ** 6  # haustral folds
    base_r = 0.70 + 0.26 * (n - 0.5) * 2.0 - vessels - rings
    base_g = 0.38 + 0.16 * (n - 0.5) * 2.0 - 0.8 * vessels - 0.5 * rings
    base_b = 0.30 + 0.10 * (n - 0.5) * 2.0 - 0.6 * vessels - 0.5 * rings
    return np.clip(np.stack([base_r, base_g, base_b], axis=-1), 0.0, 1.0)


@dataclass
class ColonSequence:
    """A rendered sequence with exact ground truth.

    frames: (N, H, W, 3) float32 in [0, 1]
    depths: (N, H, W) float32 metric GT depth (cam-frame z)
    poses:  (N, 4, 4) float32 cam→world transforms (world = cylinder frame)
    k:      (3, 3) float32 intrinsics
    """

    frames: np.ndarray
    depths: np.ndarray
    poses: np.ndarray
    k: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.frames.shape[0]

    def relative_pose(self, i: int, j: int) -> np.ndarray:
        """GT transform mapping frame-i cam coords → frame-j cam coords."""
        return np.linalg.inv(self.poses[j]) @ self.poses[i]


def default_intrinsics(height: int, width: int) -> np.ndarray:
    """Colonoscope-ish wide-FOV pinhole K (post-undistortion, SURVEY.md D3)."""
    return np.array(
        [[0.6 * width, 0.0, width / 2.0],
         [0.0, 0.6 * width, height / 2.0],
         [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def _rot_small(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix from small Euler angles (XYZ order)."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    rx_m = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry_m = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz_m = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz_m @ ry_m @ rx_m).astype(np.float64)


def make_trajectory(
    n_frames: int,
    step: float = 0.01,
    wobble: float = 0.15,
    seed: int = 11,
) -> np.ndarray:
    """Camera trajectory down the colon axis: forward motion + smooth wobble.

    Returns (N, 4, 4) cam→world poses. The camera looks roughly down +z
    (the cylinder axis) and advances ``step`` meters per frame with
    sinusoidal lateral sway and gentle pitch/yaw — colonoscope-like motion
    (loopy paths as in ``imgs/trajectorypredictions.png``).
    """
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * np.pi, size=6)
    poses = np.zeros((n_frames, 4, 4), dtype=np.float64)
    for i in range(n_frames):
        z = i * step
        tx = wobble * 0.02 * np.sin(2.1 * z * np.pi + phases[0])
        ty = wobble * 0.02 * np.sin(1.7 * z * np.pi + phases[1])
        rxa = wobble * 0.10 * np.sin(1.3 * z * np.pi + phases[2])
        rya = wobble * 0.10 * np.sin(0.9 * z * np.pi + phases[3])
        rza = wobble * 0.05 * np.sin(0.7 * z * np.pi + phases[4])
        t_mat = np.eye(4)
        t_mat[:3, :3] = _rot_small(rxa, rya, rza)
        t_mat[:3, 3] = (tx, ty, z)
        poses[i] = t_mat
    return poses.astype(np.float32)


def render_frame(
    pose_cw: np.ndarray,
    k: np.ndarray,
    height: int,
    width: int,
    radius: float = 0.03,
    light_falloff: bool = True,
    ambient: float = 0.25,
    texture_seed: int = 7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one frame inside the cylinder x²+y²=R².

    Args:
        pose_cw: (4, 4) cam→world. Camera must be inside the cylinder.

    Returns:
        (rgb (H, W, 3), depth (H, W)) — depth is cam-frame z, exactly the
        quantity DepthNet predicts.
    """
    pose_cw = pose_cw.astype(np.float64)
    k = k.astype(np.float64)
    k_inv = np.linalg.inv(k)

    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    u, v = np.meshgrid(xs, ys)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1)  # (H, W, 3)
    d_cam = pix @ k_inv.T  # z-normalized ray dirs (z component == 1)

    rot = pose_cw[:3, :3]
    origin = pose_cw[:3, 3]
    d_w = d_cam @ rot.T  # (H, W, 3)

    # Solve |o_xy + t·d_xy|² = R² for t > 0  (o strictly inside ⇒ c < 0,
    # one positive root).
    a = d_w[..., 0] ** 2 + d_w[..., 1] ** 2
    b = 2.0 * (origin[0] * d_w[..., 0] + origin[1] * d_w[..., 1])
    c = origin[0] ** 2 + origin[1] ** 2 - radius**2
    a = np.maximum(a, 1e-12)
    disc = np.maximum(b * b - 4 * a * c, 0.0)
    t = (-b + np.sqrt(disc)) / (2 * a)
    # Rays nearly parallel to the axis never hit the wall: cap at far depth.
    t_far = 2.0 / np.maximum(np.sqrt(a), 1e-6)
    t = np.minimum(t, t_far)

    hit_w = origin + t[..., None] * d_w  # (H, W, 3)
    depth = t.astype(np.float32)  # d_cam z==1 ⇒ t equals cam-frame z

    theta = np.arctan2(hit_w[..., 1], hit_w[..., 0])
    z_coord = hit_w[..., 2]
    albedo = colon_texture(theta.astype(np.float32), z_coord.astype(np.float32), texture_seed)

    if light_falloff:
        # Headlight model: light co-located with camera. Irradiance ∝
        # cos(incidence)/dist². Normalize so a wall at ~1.5R is mid-bright.
        normal = -np.stack(
            [hit_w[..., 0], hit_w[..., 1], np.zeros_like(z_coord)], axis=-1
        ) / radius
        ray_n = d_w / np.linalg.norm(d_w, axis=-1, keepdims=True)
        cosi = np.abs(np.sum(ray_n * normal, axis=-1))
        dist = t * np.linalg.norm(d_w, axis=-1)
        irr = cosi / np.maximum(dist / (1.5 * radius), 0.3) ** 2
        shade = ambient + (1 - ambient) * np.clip(irr, 0.0, 1.0)
        rgb = albedo * shade[..., None]
    else:
        rgb = albedo
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), depth


def render_sequence(
    n_frames: int = 24,
    height: int = 96,
    width: int = 128,
    radius: float = 0.03,
    step: float = 0.004,
    wobble: float = 0.3,
    k: np.ndarray | None = None,
    seed: int = 11,
    light_falloff: bool = True,
    exposure_jitter: float = 0.0,
) -> ColonSequence:
    """Render a full sequence with GT depth + poses.

    ``exposure_jitter`` models endoscope auto-exposure: each frame's RGB
    is scaled by an independent gain ~ U(1-j, 1+j) (then clipped — bright
    walls saturate, as real sensors do). This is the photometric nuisance
    LCC exists to absorb (reference README.md:6-7 "brightness
    variations"); the headlight falloff alone is geometrically consistent
    between frames, so it does not exercise LCC (see runs/ablate)."""
    if k is None:
        k = np.array(
            [[0.6 * width, 0.0, width / 2.0],
             [0.0, 0.6 * width, height / 2.0],
             [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
    poses = make_trajectory(n_frames, step=step, wobble=wobble, seed=seed)
    frames = np.zeros((n_frames, height, width, 3), dtype=np.float32)
    depths = np.zeros((n_frames, height, width), dtype=np.float32)
    gain_rng = np.random.default_rng(seed + 77)
    for i in range(n_frames):
        frames[i], depths[i] = render_frame(
            poses[i], k, height, width, radius, light_falloff=light_falloff
        )
        if exposure_jitter:
            gain = 1.0 + gain_rng.uniform(-exposure_jitter, exposure_jitter)
            frames[i] = np.clip(frames[i] * gain, 0.0, 1.0)
    return ColonSequence(frames=frames, depths=depths, poses=poses, k=k)
