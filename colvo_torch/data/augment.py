"""Snippet augmentation (numpy-only copy of ``colvo/data/augment.py``).

Color jitter and horizontal flip, applied identically to all frames of a
snippet; losses are computed on the non-jittered copies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from colvo_torch.config import DataConfig


def _rgb_to_gray(x: np.ndarray) -> np.ndarray:
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def color_jitter(
    frames: np.ndarray, cfg: DataConfig, rng: np.random.Generator
) -> np.ndarray:
    """One jitter draw per snippet, same transform for every frame."""
    out = frames
    if cfg.brightness > 0:
        out = out * rng.uniform(1 - cfg.brightness, 1 + cfg.brightness)
    if cfg.contrast > 0:
        mean = out.mean(axis=(-3, -2, -1), keepdims=True)
        out = (out - mean) * rng.uniform(1 - cfg.contrast, 1 + cfg.contrast) + mean
    if cfg.saturation > 0:
        gray = _rgb_to_gray(out)
        out = gray + (out - gray) * rng.uniform(1 - cfg.saturation, 1 + cfg.saturation)
    if cfg.hue > 0:
        # cheap hue-ish channel rotation: mix channels slightly
        shift = rng.uniform(-cfg.hue, cfg.hue)
        out = out + shift * (np.roll(out, 1, axis=-1) - out)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def augment_snippet(
    batch_frames: np.ndarray, cfg: DataConfig, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """(B, F, H, W, 3) → (augmented, clean). Flip applies to both (it is a
    geometric change); jitter only to the network-input copy."""
    clean = batch_frames
    if cfg.hflip:
        flip = rng.random(len(batch_frames)) < 0.5
        clean = np.where(flip[:, None, None, None, None], batch_frames[:, :, :, ::-1], batch_frames)
    aug = np.stack([color_jitter(snippet, cfg, rng) for snippet in clean])
    return aug.astype(np.float32), clean.astype(np.float32)
