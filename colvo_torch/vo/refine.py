"""Test-time keyframe pose refinement (port of ``colvo/vo/refine.py``).

After the chunked VO pass, the relative pose of every consecutive keyframe
pair is optimised again against the photometric + depth-consistency
evidence at the keyframes' own (longer) baseline: an (M, 6) se(3) delta
around the chained initialisation, Adam in optax's order
(``runtime/optim.py``), the warps through kernel S with d/dx, d/dy
(gradients flow to the pose only: frames and depths are data at test
time). A pair keeps its refined pose only where its residual fell. The
refined segment transforms then re-anchor the trajectory in float64: each
intra-segment relative chain is kept, segments are re-chained through
the refined keyframe poses.

On a CUDA device each loss evaluation under the gradient launches S twice
(the frame, C=3, and the depth, C=1); the residuals before and after
launch its value-only form. A call of a batch shape is one replay of a
CUDA graph (``runtime.graphs``) that holds every iteration.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.geometry import backproject, project
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.geometry.se3 import se3_exp
from colvo_torch.kernels import bilinear_sample_fast
from colvo_torch.losses.photometric import lcc_calibrate, photometric_error
from colvo_torch.runtime.graphs import Graphed
from colvo_torch.runtime.optim import Adam


def _segment_loss(delta6, rel_init, frame_i, frame_j, depth_i, depth_j, k, k_inv,
                  geo_weight):
    """Mean photometric+geo residual of keyframe pairs under T = exp(δ)·T0,
    and the residual of each pair.

    frame/depth tensors are (M, H, W, C)/(M, H, W); rel_init (M, 4, 4) maps
    keyframe i → keyframe j (camera-relative, network scale).
    """
    t_mat = torch.einsum("mij,mjk->mik", se3_exp(delta6), rel_init)
    pts = backproject(depth_i, k_inv)
    pix, z = project(pts, k, t_mat)
    h, w = depth_i.shape[1], depth_i.shape[2]
    valid = _valid_mask(pix, h, w) * (z > 0)

    warped = bilinear_sample_fast(frame_j, pix)
    calib = lcc_calibrate(warped, frame_i, "global+affine", valid_mask=valid)
    photo = photometric_error(calib, frame_i)

    # depth consistency at the longer baseline: projected z against the
    # warped source depth (data: only the pose moves at test time)
    d_j = bilinear_sample_fast(depth_j.detach()[..., None], pix)[..., 0]
    geo = torch.abs(z - d_j) / (z + d_j + 1e-6)

    denom = torch.sum(valid, dim=(1, 2)) + 1e-6
    photo_m = torch.sum(photo * valid, dim=(1, 2)) / denom
    geo_m = torch.sum(geo * valid, dim=(1, 2)) / denom
    per_pair = photo_m + geo_weight * geo_m
    return torch.mean(per_pair), per_pair


def _refine_body(rel_init, frame_i, frame_j, depth_i, depth_j, k, iters: int = 40,
                 lr: float = 1e-3, geo_weight: float = 0.5):
    """``colvo/vo/refine.py::_refine_jit``: ``iters`` Adam steps on the
    delta, then a pair keeps its refined pose only where the residual fell
    (a diverged trajectory must not poison the chain). Returns (refined
    (M, 4, 4) transforms, mean residual before, mean of the kept residuals).
    The delta and Adam's moments are made here, so every call starts from
    zero; nothing is read on the host."""
    k_inv = torch.linalg.inv_ex(k).inverse
    args = (rel_init, frame_i, frame_j, depth_i, depth_j, k, k_inv, geo_weight)
    delta = torch.zeros((rel_init.shape[0], 6), dtype=torch.float32, device=k.device,
                        requires_grad=True)
    opt = Adam([delta], lr=lr, capturable=k.is_cuda)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        _segment_loss(delta, *args)[0].backward()
        opt.step()
    with torch.no_grad():
        _, res0 = _segment_loss(torch.zeros_like(delta), *args)
        _, res1 = _segment_loss(delta, *args)
        keep = (res1 < res0)[:, None]
        kept = torch.where(keep, delta, torch.zeros_like(delta))
        t_ref = torch.einsum("mij,mjk->mik", se3_exp(kept), rel_init)
    return t_ref, torch.mean(res0), torch.mean(torch.minimum(res0, res1))


# The refinement as one program, as the reference jits ``_refine_jit``: on
# CUDA one CUDA graph a (batch shape, iters, lr, geo_weight) holds all the
# Adam iterations and the keep-or-reject step, kept for the process as
# jit's cache is. Its outputs are overwritten by the next call.
_refine = Graphed(_refine_body)


def refine_keyframe_poses(
    poses: np.ndarray,
    keyframe_ids: List[int],
    depths: List[np.ndarray],
    frames_kf: np.ndarray,
    k: np.ndarray,
    iters: int = 40,
    lr: float = 1e-3,
    geo_weight: float = 0.5,
    batch: int = 64,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, dict]:
    """Refine a chained trajectory through its keyframe segments, on
    ``device``.

    Args:
        poses: (N, 4, 4) cam→world chained trajectory (vo.poses).
        keyframe_ids / depths: VOResult keyframe protocol (depths in the
            network's own scale — no alignment applied).
        frames_kf: (M, H, W, 3) frames AT the keyframes (floats in [0, 1],
            or in [0, 255], which are scaled down).
        k: (3, 3) intrinsics.
        batch: pairs a refinement call; the last call repeats its last
            pair up to ``batch``.

    Returns (refined (N, 4, 4) float64 poses, stats dict). The intra-segment
    relative chains are kept; only the keyframe-to-keyframe transforms move.
    """
    device = resolve_device(device)
    ids = list(keyframe_ids)
    m = len(ids) - 1
    if m < 1:
        return poses, {"pairs": 0}
    frames_kf = np.asarray(frames_kf, np.float32)
    if frames_kf.dtype == np.uint8 or frames_kf.max() > 1.5:
        frames_kf = frames_kf.astype(np.float32) / 255.0
    d = np.stack([np.asarray(x, np.float32) for x in depths])

    # the projection path's convention (target i, source j): the inverse of
    # the cam→world step, as the pose net emits it
    rel = np.stack([
        np.linalg.inv(poses[ids[i + 1]]) @ poses[ids[i]]
        for i in range(m)
    ]).astype(np.float32)

    k_t = torch.from_numpy(np.asarray(k, np.float32)).to(device)
    t_ref_all = []
    res0_all, res1_all = [], []
    for s in range(0, m, batch):
        e = min(s + batch, m)
        pad = batch - (e - s)

        def p(x):
            x = x[s:e]
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        t_ref, r0, r1 = _refine(p(rel), p(frames_kf[:-1]), p(frames_kf[1:]), p(d[:-1]),
                                p(d[1:]), k_t, iters=iters, lr=lr, geo_weight=geo_weight)
        t_ref_all.append(t_ref.to("cpu", copy=True).numpy()[: e - s])
        res0_all.append(float(r0))
        res1_all.append(float(r1))
    t_ref = np.concatenate(t_ref_all)

    # Re-chain: keyframe poses step through the refined segment transforms
    # (cam→world step S = inv(T_ref)); interior frames keep their pose
    # relative to their own segment's start.
    refined = poses.astype(np.float64).copy()
    p_i = refined[ids[0]].copy()
    for seg in range(m):
        s_ref = np.linalg.inv(np.asarray(t_ref[seg], np.float64))
        base_old = poses[ids[seg]].astype(np.float64)
        rebase = p_i @ np.linalg.inv(base_old)
        for t in range(ids[seg] + 1, ids[seg + 1]):
            refined[t] = rebase @ poses[t].astype(np.float64)
        p_i = p_i @ s_ref
        refined[ids[seg + 1]] = p_i
    # tail frames past the last keyframe
    base_old = poses[ids[-1]].astype(np.float64)
    rebase = p_i @ np.linalg.inv(base_old)
    for t in range(ids[-1] + 1, poses.shape[0]):
        refined[t] = rebase @ poses[t].astype(np.float64)

    stats = {
        "pairs": m,
        "residual_before": float(np.mean(res0_all)),
        "residual_after": float(np.mean(res1_all)),
    }
    return refined, stats
