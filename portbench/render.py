"""Synthetic colonoscopy frames drawn from a seed, on the device.

A PyTorch copy of the program's renderer (``data/synthetic.py``): a
camera moves down a textured cylinder of radius 3 cm with a smooth wobble
and a headlight whose falloff shades the wall; the texture is multi-octave
value noise with vessels and haustral rings in colon-like tones. Frames
come out as uint8 (N, H, W, 3) on the device. Each sequence takes its own
trajectory phases, texture seed and exposure from the seed: a gain for the
whole sequence and an auto-exposure flicker frame by frame, the brightness
changes that LCC exists to absorb.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RADIUS = 0.03
STEP = 0.004  # metres the camera advances a frame
WOBBLE = 0.3
AMBIENT = 0.25


def intrinsics(height: int, width: int) -> np.ndarray:
    return np.array([[0.6 * width, 0.0, width / 2.0], [0.0, 0.6 * width, height / 2.0],
                     [0.0, 0.0, 1.0]], np.float32)


def _hash(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    m = 0xFFFFFFFF
    h = ((ix & m) * 374761393 + (iy & m) * 668265263 + ((seed * 2246822519) & m)) & m
    h = h ^ (h >> 13)
    h = (h * 1274126177) & m
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) / float(0x1000000)


def _noise(x: torch.Tensor, y: torch.Tensor, seed: int) -> torch.Tensor:
    fx, fy = x - torch.floor(x), y - torch.floor(y)
    ix, iy = torch.floor(x).to(torch.int64), torch.floor(y).to(torch.int64)
    fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
    v00, v10 = _hash(ix, iy, seed), _hash(ix + 1, iy, seed)
    v01, v11 = _hash(ix, iy + 1, seed), _hash(ix + 1, iy + 1, seed)
    return (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy


def _texture(theta: torch.Tensor, z: torch.Tensor, seed: int) -> torch.Tensor:
    u, v = theta * 6.0, z * 60.0
    n = torch.zeros_like(u)
    amp, freq, norm = 1.0, 1.0, 0.0
    for octave in range(5):
        n = n + amp * _noise(u * freq, v * freq, seed + octave)
        norm += amp
        amp, freq = amp * 0.55, freq * 2.1
    n = n / norm
    vessels = 0.22 * torch.sin(9.0 * theta + 110.0 * z + 5.0 * n) ** 8
    rings = 0.15 * torch.cos(2 * math.pi * z / 0.08) ** 6
    r = 0.70 + 0.52 * (n - 0.5) - vessels - rings
    g = 0.38 + 0.32 * (n - 0.5) - 0.8 * vessels - 0.5 * rings
    b = 0.30 + 0.20 * (n - 0.5) - 0.6 * vessels - 0.5 * rings
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)


def _poses(n: int, phases: np.ndarray, start: int) -> torch.Tensor:
    """(n, 4, 4) float64 camera→world poses of frames start .. start + n."""
    z = (start + np.arange(n)) * STEP
    tx = WOBBLE * 0.02 * np.sin(2.1 * z * np.pi + phases[0])
    ty = WOBBLE * 0.02 * np.sin(1.7 * z * np.pi + phases[1])
    ang = [WOBBLE * a * np.sin(f * z * np.pi + phases[i])
           for i, (a, f) in enumerate(((0.10, 1.3), (0.10, 0.9), (0.05, 0.7)), start=2)]
    cx, sx = np.cos(ang[0]), np.sin(ang[0])
    cy, sy = np.cos(ang[1]), np.sin(ang[1])
    cz, sz = np.cos(ang[2]), np.sin(ang[2])
    one, zero = np.ones(n), np.zeros(n)
    rx = np.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(n, 3, 3)
    ry = np.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(n, 3, 3)
    rz = np.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(n, 3, 3)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = rz @ ry @ rx
    out[:, :3, 3] = np.stack([tx, ty, z], -1)
    return torch.from_numpy(out)


def render(n_frames: int, height: int, width: int, seed: int, device, gain: float = 1.0,
           jitter: float = 0.0, block: int = 32) -> torch.Tensor:
    """One sequence of ``n_frames`` uint8 RGB frames (N, H, W, 3) on
    ``device``; the frames' light is scaled by ``gain`` and, frame by frame,
    by an auto-exposure factor uniform in [1 − jitter, 1 + jitter] (bright
    walls saturate)."""
    rng = np.random.default_rng(seed)
    phases, tex_seed = rng.uniform(0, 2 * np.pi, size=6), int(rng.integers(0, 2**20))
    exposure = gain * (1.0 + rng.uniform(-jitter, jitter, size=n_frames))
    k_inv = torch.from_numpy(np.linalg.inv(intrinsics(height, width).astype(np.float64)))
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64),
                            torch.arange(width, dtype=torch.float64), indexing="ij")
    d_cam = (torch.stack([xs, ys, torch.ones_like(xs)], -1) @ k_inv.T).to(device)
    out = torch.empty((n_frames, height, width, 3), dtype=torch.uint8, device=device)
    for start in range(0, n_frames, block):
        n = min(block, n_frames - start)
        pose = _poses(n, phases, start).to(device)
        d = torch.einsum("nij,hwj->nhwi", pose[:, :3, :3], d_cam)
        o = pose[:, None, None, :3, 3]
        a = (d[..., 0] ** 2 + d[..., 1] ** 2).clamp(min=1e-12)
        b = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
        c = o[..., 0] ** 2 + o[..., 1] ** 2 - RADIUS**2
        t = (-b + torch.sqrt((b * b - 4 * a * c).clamp(min=0.0))) / (2 * a)
        t = torch.minimum(t, 2.0 / torch.sqrt(a).clamp(min=1e-6))
        hit = o + t[..., None] * d
        albedo = _texture(torch.atan2(hit[..., 1], hit[..., 0]).float(), hit[..., 2].float(),
                          tex_seed)
        normal = -torch.stack([hit[..., 0], hit[..., 1], torch.zeros_like(t)], -1) / RADIUS
        dn = torch.linalg.norm(d, dim=-1)
        cosi = torch.abs(torch.sum(d / dn[..., None] * normal, dim=-1))
        irr = cosi / torch.clamp(t * dn / (1.5 * RADIUS), min=0.3) ** 2
        shade = (AMBIENT + (1 - AMBIENT) * irr.clamp(0.0, 1.0)).float()
        light = torch.from_numpy(exposure[start:start + n]).float().to(device)
        rgb = (albedo * shade[..., None] * light[:, None, None, None]).clamp(0.0, 1.0)
        out[start:start + n] = torch.round(rgb * 255.0).to(torch.uint8)
    return out


def corpus(n_sequences: int, n_frames: int, height: int, width: int, seed: int, device,
           gain=(1.0, 1.0), jitter: float = 0.0):
    """``n_sequences`` sequences, each of its own seed and of a gain uniform
    in ``gain`` (procedures lit differently): a list of uint8 tensors."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**62, size=n_sequences)
    gains = rng.uniform(gain[0], gain[1], size=n_sequences)
    return [render(n_frames, height, width, int(s), device, float(g), jitter)
            for s, g in zip(seeds, gains)]
