"""The loaders' first batches, worked out again from the corpus and the seed.

Both loaders shuffle snippets with ``numpy.random.default_rng(seed)``'s
permutation of each epoch and drop the last partial batch. A snippet is
its target frame followed by its source frames at ``frame_offsets``.
Augmentation: one draw a snippet, a horizontal flip of both copies, then
brightness, contrast (about each frame's mean), saturation (about the
luma) and a hue mix of the channels on the network-input copy, clipped to
[0, 1].

* ``device`` loader: uint8 frames × float32(1/255); the draws come from a
  ``torch.Generator`` on the corpus's device seeded with the seed, in the
  order flip, brightness, contrast, saturation, hue, a batch at a time.
* ``numpy`` loader: the float32 frames the dataset holds; the draws come
  from the same numpy generator after the permutation, the flips of the
  batch first and then the four jitter factors of each snippet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def snippet_table(n_frames: List[int], offsets) -> np.ndarray:
    """(S, F) global frame index of each snippet, sequences concatenated."""
    lo, hi = min(0, *offsets), max(0, *offsets)
    rows, base = [], 0
    for n in n_frames:
        rows += [[base + t] + [base + t + o for o in offsets] for t in range(-lo, n - hi)]
        base += n
    return np.asarray(rows, np.int64)


def _gray(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def device_batches(frames_u8: torch.Tensor, table: np.ndarray, data_cfg, seed: int,
                   n: int) -> List[dict]:
    """The first ``n`` batches of the device loader (frames and frames_clean
    on the corpus's device)."""
    b = data_cfg.batch_size
    order = np.random.default_rng(seed).permutation(len(table))
    gen = torch.Generator(device=frames_u8.device).manual_seed(seed)
    dev = frames_u8.device
    out = []
    for i in range(n):
        idx = torch.from_numpy(table[order[i * b:(i + 1) * b]]).to(dev)
        x = frames_u8[idx].to(torch.float32) * (1.0 / 255.0)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

        flip = torch.rand(b, generator=gen, device=dev) < 0.5
        clean = torch.where(flip.reshape(-1, 1, 1, 1, 1), x.flip(3), x)
        v = {name: uniform(1 - getattr(data_cfg, name), 1 + getattr(data_cfg, name))
             for name in ("brightness", "contrast", "saturation")}
        hue = uniform(-data_cfg.hue, data_cfg.hue)
        per = {k: t.reshape(-1, 1, 1, 1, 1) for k, t in v.items()}
        aug = clean * per["brightness"]
        mean = aug.mean(dim=(-3, -2, -1), keepdim=True)
        aug = (aug - mean) * per["contrast"] + mean
        g = _gray(aug)
        aug = g + (aug - g) * per["saturation"]
        aug = aug + hue.reshape(-1, 1, 1, 1, 1) * (torch.roll(aug, 1, dims=-1) - aug)
        out.append({"frames": aug.clamp(0.0, 1.0), "frames_clean": clean})
    return out


def numpy_batches(sequences: List[np.ndarray], table: np.ndarray, data_cfg, seed: int,
                  n: int) -> List[dict]:
    """The first ``n`` batches of the numpy loader, as numpy arrays."""
    b = data_cfg.batch_size
    flat = np.concatenate(sequences)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(table))
    out = []
    for i in range(n):
        frames = flat[table[order[i * b:(i + 1) * b]]]
        flip = rng.random(b) < 0.5
        clean = np.where(flip[:, None, None, None, None], frames[:, :, :, ::-1], frames)
        aug = []
        for snip in clean:
            x = snip * rng.uniform(1 - data_cfg.brightness, 1 + data_cfg.brightness)
            mean = x.mean(axis=(-3, -2, -1), keepdims=True)
            x = (x - mean) * rng.uniform(1 - data_cfg.contrast, 1 + data_cfg.contrast) + mean
            g = _gray(x)
            x = g + (x - g) * rng.uniform(1 - data_cfg.saturation, 1 + data_cfg.saturation)
            x = x + rng.uniform(-data_cfg.hue, data_cfg.hue) * (np.roll(x, 1, axis=-1) - x)
            aug.append(np.clip(x, 0.0, 1.0).astype(np.float32))
        out.append({"frames": np.stack(aug), "frames_clean": clean.astype(np.float32)})
    return out
