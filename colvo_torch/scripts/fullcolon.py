"""Full-colon 3-D reconstruction at the reference's scale (port of
``scripts/fullcolon.py``).

A long rendered colonoscopy (3,000 frames by default, trajectory seed
2026) streams through ``run_vo`` in chunks of 32 with keyframe depths kept
in the stream (every ``keyframe_every``-th frame: O(N/k) host memory,
O(chunk) device memory) and the symmetrised pose reading; optionally the
keyframe poses are refined (``vo.refine``); the trajectory is
sim(3)-aligned to the ground truth, the keyframe depths are stitched
through the aligned poses (voxel grid in the native library, a depth cap
relative to each frame's median), and so are the ground-truth depths at
the same keyframes. Three polyps at keyframes are localised
(``localize_polyps``, with ``_box_depth`` diagnostics), and the pair of
clouds is drawn with the trajectories and polyp markers.

Writes under ``out_dir`` (``runs/fullcolon``): ``fullcolon_recon.png``,
``fullcolon_ours.ply.gz``, ``fullcolon.json`` and ``FULLCOLON.md``. The
rendered frames are cached as ``longvideo_<n>_<h>x<w>.npz`` in the
temporary directory (``tempfile.gettempdir()``: ``/tmp`` unless
``TMPDIR`` names another), the reference's cache file; rendering is host
numpy, about 50 ms a frame at 256×320, so 3,000 frames take minutes the
first time. The default weights are those the port's demo exports
(``python -m colvo_torch.scripts.demo_synthetic``).

Run: ``python -m colvo_torch.scripts.fullcolon [n_frames] [weights]
[out_dir] [--device cuda|cpu] [--keyframe-every 10] [--voxel 0.003]
[--stitch-depth-cap 1.6] [--no-symmetric-pose] [--wire uint8] [--refine]``.
The options are the reference's ``COLVO_KEYFRAME_EVERY``, ``COLVO_VOXEL``,
``COLVO_STITCH_DEPTH_CAP``, ``COLVO_SYM_POSE``, ``COLVO_WIRE`` and
``COLVO_REFINE``, with the same defaults; no environment variable is read.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.synthetic import default_intrinsics, make_trajectory, render_frame
from colvo_torch.evaluation import evaluate_pose
from colvo_torch.evaluation.viz import viz_recon_pair
from colvo_torch.pipelines import make_runner
from colvo_torch.vo import (
    PolypDetection,
    VOResult,
    localize_polyps,
    run_vo,
    save_ply,
    stitch_pointclouds,
    umeyama,
)
from colvo_torch.vo.polyps import _box_depth
from colvo_torch.vo.refine import refine_keyframe_poses

DEFAULT_WEIGHTS = "runs/demo/weights.npz"
WARMUP_FRAMES = 65  # frames of the warm-up run outside the clock (two chunks and a frame)


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


def render_frames(gt_poses: np.ndarray, k: np.ndarray, h: int, w: int,
                  exp_jitter: Optional[float] = None) -> np.ndarray:
    """(N, H, W, 3) uint8 frames along ``gt_poses``, through the cache file
    in the temporary directory: ``longvideo_<n>_<h>x<w>.npz``, or with
    ``exp_jitter`` given (the long-video arms) ``..._j<exp_jitter>.npz`` and
    each frame scaled by an independent gain U(1-j, 1+j) from the generator
    ``2026 + 77``, then clipped (the training corpus's protocol)."""
    n = len(gt_poses)
    tag = "" if exp_jitter is None else f"_j{exp_jitter}"
    cache = os.path.join(tempfile.gettempdir(), f"longvideo_{n}_{h}x{w}{tag}.npz")
    if os.path.exists(cache):
        print(f"loaded cached render {cache}", flush=True)
        with np.load(cache) as data:
            return data["frames"]
    print(f"rendering {n} frames {h}x{w}" + (f" jitter={exp_jitter}" if tag else "") + " ...",
          flush=True)
    gain_rng = np.random.default_rng(2026 + 77)
    frames_u8 = np.zeros((n, h, w, 3), dtype=np.uint8)
    for i in range(n):
        f, _ = render_frame(gt_poses[i], k, h, w, radius=0.03)
        if exp_jitter:
            f = np.clip(f * (1.0 + gain_rng.uniform(-exp_jitter, exp_jitter)), 0.0, 1.0)
        frames_u8[i] = np.clip(f * 255.0, 0, 255).astype(np.uint8)
    np.savez(cache, frames=frames_u8)
    return frames_u8


def main(n_frames: int = 3000, weights: str = DEFAULT_WEIGHTS, out_dir: str = "runs/fullcolon",
         device: str = "cuda", keyframe_every: int = 10, voxel: float = 0.003,
         stitch_depth_cap: float = 1.6, symmetric_pose: bool = True, wire: str = "uint8",
         refine: bool = False) -> dict:
    """The full-colon run; returns the record written to ``fullcolon.json``.

    Args:
        keyframe_every: keep every k-th frame's depth (the stitched frames).
        voxel: the stitch's voxel size (m).
        stitch_depth_cap: stitch only points nearer than this many times
            each frame's median depth. Rays nearly parallel to the lumen
            axis hit the renderer's far cap and the model's far predictions
            are unconstrained; a cap relative to the median keeps the same
            near-wall share under any sim(3) scale.
        symmetric_pose: read each pair both ways (the pose net's order bias
            cancels).
        wire: the stream's depth wire (uint8: ≤0.2-0.4 % relative depth
            error, under the 3 mm voxel, at half float16's bytes).
        refine: refine the keyframe poses (``vo.refine``) before the
            alignment; off by default, as the reference's.
    """
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = ColvoConfig()
    h, w = cfg.data.height, cfg.data.width
    k = default_intrinsics(h, w)
    # the long-video proof's trajectory and cache
    gt_poses = make_trajectory(n_frames, step=0.004, wobble=0.3, seed=2026)
    frames_u8 = render_frames(gt_poses, k, h, w)

    runner = make_runner(cfg, weights, device)
    # The warm-up (program captures, cuDNN's choices) runs outside the clock.
    vo_kw = dict(keyframe_every=keyframe_every, chunk_size=32, depth_dtype=wire,
                 symmetric_pose=symmetric_pose)
    t0 = time.time()
    run_vo(runner, iter(frames_u8[:WARMUP_FRAMES]), **vo_kw)
    compile_s = time.time() - t0
    t0 = time.time()
    vo = run_vo(runner, iter(frames_u8), **vo_kw)
    vo_s = time.time() - t0
    print(f"VO: {n_frames} frames in {vo_s:.1f}s ({n_frames / vo_s:.1f} fps; warm-up "
          f"{compile_s:.1f}s excluded), {len(vo.depths)} keyframe depths, RSS {_rss_mb():.0f} MB",
          flush=True)

    gt64 = gt_poses.astype(np.float64)
    pose_metrics_raw = evaluate_pose(vo.poses, gt64)
    refine_stats = {}
    if refine:
        t0 = time.time()
        refined, refine_stats = refine_keyframe_poses(
            vo.poses, vo.keyframe_ids, vo.depths, frames_u8[vo.keyframe_ids], k, device=device)
        refine_stats["refine_s"] = round(time.time() - t0, 1)
        vo = VOResult(poses=refined, depths=vo.depths, keyframe_ids=vo.keyframe_ids)
        print(f"keyframe refine: {refine_stats}", flush=True)
    pose_metrics = evaluate_pose(vo.poses, gt64)

    # sim(3) alignment (monocular scale): poses into the GT frame, depths
    # scaled by the same s, so the clouds share a metric scale
    rot, tvec, s = umeyama(vo.poses[:, :3, 3], gt64[:, :3, 3])
    apose = vo.poses.astype(np.float64).copy()
    apose[:, :3, 3] = (s * (rot @ vo.poses[:, :3, 3].T)).T + tvec
    apose[:, :3, :3] = rot @ vo.poses[:, :3, :3]
    vo_aligned = VOResult(poses=apose, depths=[d * s for d in vo.depths],
                          keyframe_ids=vo.keyframe_ids)

    # the GT reconstruction from GT depths at the same keyframes
    t0 = time.time()
    gt_depths = [render_frame(gt_poses[fid], k, h, w, radius=0.03)[1].astype(np.float32)
                 for fid in vo.keyframe_ids]
    gt_vo = VOResult(poses=gt64, depths=gt_depths, keyframe_ids=list(vo.keyframe_ids))
    print(f"GT keyframe depths rendered in {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    cloud_ours = stitch_pointclouds(vo_aligned, k, frames=frames_u8, voxel=voxel,
                                    max_depth_rel=stitch_depth_cap)
    cloud_gt = stitch_pointclouds(gt_vo, k, frames=frames_u8, voxel=voxel,
                                  max_depth_rel=stitch_depth_cap)
    print(f"stitched: ours {len(cloud_ours)} pts, GT {len(cloud_gt)} pts in "
          f"{time.time() - t0:.1f}s, RSS {_rss_mb():.0f} MB", flush=True)

    # polyps at keyframes whose GT 3-D position is exact (GT depth lifted
    # through GT pose); a detection lies on the visible wall, so its centre
    # is drawn again until its GT depth is within 2× the frame's median
    rng = np.random.default_rng(5)
    k_inv64 = np.linalg.inv(k.astype(np.float64))
    dets, gts, polyp_diag = [], [], []
    for frac in (0.25, 0.5, 0.75):
        fid = (int(n_frames * frac) // keyframe_every) * keyframe_every
        d_kf = gt_depths[vo.keyframe_ids.index(fid)]
        med = float(np.median(d_kf))
        for _ in range(100):
            cx = int(rng.integers(w // 4, 3 * w // 4))
            cy = int(rng.integers(h // 4, 3 * h // 4))
            if float(d_kf[cy, cx]) <= 2.0 * med:
                break
        dets.append(PolypDetection(frame_id=fid, box=(cx - 6, cy - 6, cx + 6, cy + 6)))
        d_gt = float(d_kf[cy, cx])
        p_cam = k_inv64 @ np.array([cx, cy, 1.0]) * d_gt
        gts.append(gt64[fid, :3, :3] @ p_cam + gt64[fid, :3, 3])
        polyp_diag.append({"fid": fid, "px": [cx, cy], "d_gt": round(d_gt, 4)})
    locs = localize_polyps(vo_aligned, k, dets, np.stack(gts))
    polyp_err = [loc.error for loc in locs]
    # each polyp's error split into the pose's position error at its frame
    # and the lifted depth, so a regression names its channel
    for diag, det in zip(polyp_diag, dets):
        dp = vo_aligned.depths[vo.keyframe_ids.index(det.frame_id)]
        _, _, d_pred = _box_depth(dp, det.box)
        diag["d_pred_aligned"] = round(float(d_pred), 4)
        diag["pose_pos_err"] = round(float(np.linalg.norm(
            apose[det.frame_id, :3, 3] - gt64[det.frame_id, :3, 3])), 4)
    print(f"polyp diag: {polyp_diag}", flush=True)

    viz_recon_pair(
        {"points": cloud_gt.points, "colors": cloud_gt.colors,
         "trajectory": gt64[:, :3, 3], "polyps": np.stack(gts),
         "title": f"Ground truth ({n_frames} frames)"},
        {"points": cloud_ours.points, "colors": cloud_ours.colors,
         "trajectory": apose[:, :3, 3],
         "polyps": np.stack([loc.position_world for loc in locs]),
         "polyp_errors": polyp_err,
         "title": f"ColVO (ours), sim(3)-aligned — ATE {pose_metrics['ate']:.4f}"},
        os.path.join(out_dir, "fullcolon_recon.png"),
        suptitle=f"Complete 3D colon reconstruction — {n_frames} frames, "
                 f"{len(vo.depths)} keyframes",
    )

    ply = os.path.join(out_dir, "fullcolon_ours.ply")
    save_ply(cloud_ours, ply)
    with open(ply, "rb") as fin, gzip.open(ply + ".gz", "wb") as fout:
        shutil.copyfileobj(fin, fout)
    os.remove(ply)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = {
        "n_frames": n_frames,
        "weights": weights,
        "keyframe_every": keyframe_every,
        "voxel": voxel,
        "vo_s": round(vo_s, 1),
        "fps": round(n_frames / vo_s, 1),
        "compile_s_excluded": round(compile_s, 1),
        "wire": wire,
        "symmetric_pose": symmetric_pose,
        **{f"raw/{kk}": round(vv, 6) for kk, vv in pose_metrics_raw.items()},
        **{f"refine/{kk}": vv for kk, vv in refine_stats.items()},
        "platform": device.type,
        "device": kind,
        "n_points_ours": len(cloud_ours),
        "n_points_gt": len(cloud_gt),
        "rss_mb_end": round(_rss_mb(), 1),
        **{kk: round(vv, 6) for kk, vv in pose_metrics.items()},
        **{f"polyp/e{i + 1}": round(e, 4) for i, e in enumerate(polyp_err)},
        "polyp/e_mean": round(float(np.mean(polyp_err)), 4),
        "polyp/diag": polyp_diag,
    }
    with open(os.path.join(out_dir, "fullcolon.json"), "w") as f:
        json.dump(rec, f, indent=1)

    lines = [
        "# Complete 3D colon reconstruction",
        "",
        f"{n_frames} rendered colonoscopy frames ({h}x{w}, trajectory seed 2026) streamed "
        f"through `run_vo` in chunks of 32 with keyframe depths kept in the stream (every "
        f"{keyframe_every}th frame, {len(vo.depths)} keyframe depths), stitched through the "
        f"sim(3)-aligned poses ({voxel} m voxels, depth cap {stitch_depth_cap}x each frame's "
        "median).",
        "",
        f"* cloud: ours {len(cloud_ours):,} pts / GT {len(cloud_gt):,} pts "
        "(`fullcolon_ours.ply.gz`)",
        f"* trajectory: ATE {pose_metrics['ate']:.4f} m (sim3), RPE rot "
        f"{pose_metrics['rpe_rot_deg']:.3f} deg/frame over {n_frames} frames"
        + (" (symmetrised pose reading)" if symmetric_pose else "")
        + (f"; keyframe refinement (ATE {pose_metrics_raw['ate']:.4f} → "
           f"{pose_metrics['ate']:.4f})" if refine_stats else ""),
        "* polyp localization e (m): " + ", ".join(f"{e:.4f}" for e in polyp_err)
        + f" (mean {np.mean(polyp_err):.4f})",
        f"* produced on: {kind}, {n_frames / vo_s:.1f} frames/s VO ({wire} wire), host RSS "
        f"{_rss_mb():.0f} MB",
        "",
        "![reconstruction](fullcolon_recon.png)",
    ]
    with open(os.path.join(out_dir, "FULLCOLON.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps(rec), flush=True)
    print(f"wrote {out_dir}/FULLCOLON.md")
    return rec


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.fullcolon",
                                     description=__doc__)
    parser.add_argument("n_frames", nargs="?", type=int, default=3000)
    parser.add_argument("weights", nargs="?", default=DEFAULT_WEIGHTS)
    parser.add_argument("out_dir", nargs="?", default="runs/fullcolon")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--keyframe-every", type=int, default=10)
    parser.add_argument("--voxel", type=float, default=0.003)
    parser.add_argument("--stitch-depth-cap", type=float, default=1.6)
    parser.add_argument("--no-symmetric-pose", dest="symmetric_pose", action="store_false")
    parser.add_argument("--wire", default="uint8", choices=("float32", "float16", "uint8"))
    parser.add_argument("--refine", action="store_true")
    args = parser.parse_args(sys.argv[1:])
    main(args.n_frames, args.weights, args.out_dir, args.device,
         keyframe_every=args.keyframe_every, voxel=args.voxel,
         stitch_depth_cap=args.stitch_depth_cap, symmetric_pose=args.symmetric_pose,
         wire=args.wire, refine=args.refine)
