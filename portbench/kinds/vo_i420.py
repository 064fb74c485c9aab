"""Streaming VO traffic from a video decoder's planes: ``kinds.vo``'s run,
window and check over the rendered pool turned into planar I420 on the
host before the window (BT.601 video range, the 2×2 mean of each chroma
block, (H·3/2, W) uint8 a frame), with ``run_vo``'s ``input_format``
"i420".

Parameters: as ``kinds.vo``'s. The reference takes the same planes
through its own plain decoding (``decode``: the chroma planes repeated
over each 2×2 block, BT.601 video range back to RGB, clipped to [0, 1]),
so the chroma subsampling is in both sides and the comparison holds the
program's decoding too.
"""

from __future__ import annotations

from typing import List, Tuple
from unittest import mock

import numpy as np
import torch

from portbench.harness import Ctx, Outcome
from portbench.kinds import serve, vo
from portbench.reference import precise


def encode(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB (N, H, W, 3) → planar I420 (N, H·3/2, W) uint8, BT.601
    video range: Y in [16, 235], the chroma of each 2×2 block its mean."""
    n, h, w, _ = frames.shape
    r, g, b = (frames[..., i].astype(np.float64) for i in range(3))
    y = 16.0 + (0.299 * r + 0.587 * g + 0.114 * b) * (219.0 / 255.0)
    u = 128.0 + (-0.168736 * r - 0.331264 * g + 0.5 * b) * (224.0 / 255.0)
    v = 128.0 + (0.5 * r - 0.418688 * g - 0.081312 * b) * (224.0 / 255.0)
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    out[:, :h] = np.clip(np.floor(y + 0.5), 0, 255)
    for at, c in ((h, u), (h + h // 4, v)):
        sub = c.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        out[:, at:at + h // 4] = np.clip(np.floor(sub + 0.5), 0, 255).reshape(n, h // 4, w)
    return out


def decode(planes: np.ndarray, device) -> torch.Tensor:
    """Planar I420 (N, H·3/2, W) uint8 → float32 RGB (N, 3, H, W) in [0, 1]."""
    x = torch.from_numpy(np.ascontiguousarray(planes)).to(device).double()
    n, h32, w = x.shape
    h = h32 * 2 // 3
    y = (x[:, :h] - 16.0) * (255.0 / 219.0)
    u = (x[:, h:h + h // 4].reshape(n, h // 2, w // 2) - 128.0) * (255.0 / 224.0)
    v = (x[:, h + h // 4:].reshape(n, h // 2, w // 2) - 128.0) * (255.0 / 224.0)
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], dim=1)
    return (rgb.clamp(0.0, 255.0) / 255.0).float()


def reference_pairs(w, cfg, prev: np.ndarray, cur: np.ndarray, device, symmetric: bool,
                    quant=None, block: int = 16) -> Tuple[np.ndarray, ...]:
    """``serve.reference_pairs`` over I420 frame pairs."""
    from portbench.reference.model import pair_forward

    outs: List[list] = [[], [], []]
    with precise(), torch.no_grad():
        for s in range(0, len(prev), block):
            sd_a, sd_b, aa, tr = pair_forward(w, decode(prev[s:s + block], device),
                                              decode(cur[s:s + block], device), cfg.model,
                                              quant, symmetric)
            for o, val in zip(outs, (sd_a, sd_b, torch.cat([aa, tr], dim=-1))):
                o.append(val.double().cpu().numpy())
    return tuple(np.concatenate(o) for o in outs)


def run(ctx: Ctx) -> Outcome:
    real_pool = serve.pool

    def pool(ctx_, cfg):
        return encode(real_pool(ctx_, cfg))

    ctx.overrides = {**ctx.overrides, "vo": {**ctx.param("vo"), "input_format": "i420"}}
    with mock.patch.object(serve, "pool", pool), \
            mock.patch.object(serve, "reference_pairs", reference_pairs):
        return vo.run(ctx)
