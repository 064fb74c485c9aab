"""What the two serving drivers share: the runner over the benchmark's
weights, the frame pool, and the comparison of served depths and poses
with the reference's.

Numbers compared (each over the sampled answers, the worst one):

* ``depth_gap``: |program's scaled disparity (1/depth) − the reference's|
  over the span of the reference's scaled disparity in that frame;
* ``pose_gap``: ‖program's 6-vector (axis-angle, translation) − the
  reference's‖ over the median norm of the reference's 6-vectors, and the
  same of the rotation (``pose_gap.rot``) and of the translation
  (``pose_gap.tr``) alone.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import render, weights
from portbench.harness import Ctx
from portbench.reference import precise
from portbench.reference.model import pair_forward
from portbench.reference.quant import fp8


def runner(ctx: Ctx, cfg):
    """(InferenceRunner over the seed's weights, the weights)."""
    from colvo_torch.runtime.infer import InferenceRunner

    w = weights.make(cfg.model, ctx.seed, ctx.device)
    return InferenceRunner(cfg, w, device=ctx.device), w


def pool(ctx: Ctx, cfg) -> np.ndarray:
    """``pool_frames`` consecutive uint8 frames (P, H, W, 3) on the host."""
    frames = render.render(int(ctx.param("pool_frames")), cfg.data.height, cfg.data.width,
                           ctx.seed, ctx.device)
    return frames.cpu().numpy()


def _nchw(frames: np.ndarray, device) -> torch.Tensor:
    """uint8 (N, H, W, 3) → float32 (N, 3, H, W) in [0, 1], as the program
    normalises."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def reference_pairs(w, cfg, prev: np.ndarray, cur: np.ndarray, device, symmetric: bool,
                    quant=None, block: int = 16) -> Tuple[np.ndarray, ...]:
    """The reference over uint8 frame pairs, in blocks: (scaled disparity of
    prev, of cur (N, H, W), pose 6-vectors (N, 6)), float64 on the host."""
    outs: List[list] = [[], [], []]
    with precise(), torch.no_grad():
        for s in range(0, len(prev), block):
            sd_a, sd_b, aa, tr = pair_forward(w, _nchw(prev[s:s + block], device),
                                              _nchw(cur[s:s + block], device), cfg.model,
                                              quant, symmetric)
            for o, v in zip(outs, (sd_a, sd_b, torch.cat([aa, tr], dim=-1))):
                o.append(v.double().cpu().numpy())
    return tuple(np.concatenate(o) for o in outs)


def depth_gap(program_sdisp: np.ndarray, ref_sdisp: np.ndarray) -> float:
    span = ref_sdisp.max(axis=(1, 2)) - ref_sdisp.min(axis=(1, 2))
    err = np.abs(program_sdisp - ref_sdisp).max(axis=(1, 2))
    return float((err / np.maximum(span, 1e-12)).max())


def pose_gap(program6: np.ndarray, ref6: np.ndarray) -> float:
    scale = max(float(np.median(np.linalg.norm(ref6, axis=1))), 1e-12)
    return float(np.linalg.norm(program6 - ref6, axis=1).max() / scale)


def pose_parts(program6: np.ndarray, ref6: np.ndarray) -> dict:
    """``pose_gap`` of the rotation and of the translation alone."""
    return {"pose_gap.rot": pose_gap(program6[:, :3], ref6[:, :3]),
            "pose_gap.tr": pose_gap(program6[:, 3:], ref6[:, 3:])}


def uint8_wire(sdisp: np.ndarray) -> np.ndarray:
    """The uint8 depth wire's round trip of scaled disparities: per frame,
    quantised linearly between its least and largest value."""
    lo = sdisp.min(axis=(1, 2), keepdims=True)
    step = np.maximum((sdisp.max(axis=(1, 2), keepdims=True) - lo) / 255.0, 1e-12)
    return lo + np.clip(np.round((sdisp - lo) / step), 0, 255) * step


def control(w, cfg, prev, cur, device, symmetric: bool, wire=None) -> Dict[str, np.ndarray]:
    """The float8 control's answers on the same inputs."""
    sd_a, sd_b, p6 = reference_pairs(w, cfg, prev, cur, device, symmetric, quant=fp8)
    if wire is not None:
        sd_a, sd_b = wire(sd_a), wire(sd_b)
    return {"sd_a": sd_a, "sd_b": sd_b, "pose": p6}
