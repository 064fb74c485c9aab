"""High-level pipelines (port of ``colvo/pipelines.py``): training,
depth inference, full-sequence VO with its reconstruction, and evaluation
on a rendered sequence or a benchmark directory, with the reference's
figures. Each is callable from Python or through ``python -m
colvo_torch.cli``, and runs on ``device`` (``cuda`` unless the caller
passes ``"cpu"``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence, synthetic_dataset
from colvo_torch.data.benchmark import list_sequences, load_benchmark_sequence
from colvo_torch.data.png import write_png
from colvo_torch.data.sources import open_source
from colvo_torch.evaluation import compute_depth_errors, evaluate_depth, evaluate_pose
from colvo_torch.evaluation.viz import colormap_depth, viz_depth_grid, viz_recon, viz_trajectory
from colvo_torch.geometry import backproject, bilinear_sample, disp_to_depth, project
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.losses import lcc_calibrate, photometric_error, poses_to_transforms
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner, load_npz
from colvo_torch.runtime.loop import train as train_loop
from colvo_torch.vo import (
    PolypDetection,
    VOResult,
    align_trajectory,
    localize_polyps,
    run_vo,
    save_ply,
    stitch_pointclouds,
    umeyama,
)
from colvo_torch.vo.driver import chain_relative_poses


def _default_k(width: int, height: int) -> np.ndarray:
    """The default colonoscope K at this resolution."""
    return np.array([[0.6 * width, 0, width / 2], [0, 0.6 * width, height / 2], [0, 0, 1]],
                    dtype=np.float32)


def build_dataset(cfg: ColvoConfig) -> SnippetDataset:
    """Dataset factory: synthetic renders or frame dirs/videos under
    ``data_root`` (one sequence per subdir/file; a dir's ``K.txt`` gives
    its intrinsics, else the default colonoscope K)."""
    if cfg.data.dataset == "synthetic":
        return synthetic_dataset(cfg.data)
    root = cfg.data.data_root
    if not root:
        raise ValueError("data.data_root required for non-synthetic datasets")
    seqs, ks = [], []
    for e in sorted(os.listdir(root)):
        path = os.path.join(root, e)
        src = open_source(path, cfg.data.width, cfg.data.height)
        seqs.append(np.stack(list(src)))
        k_file = os.path.join(path, "K.txt") if os.path.isdir(path) else None
        if k_file and os.path.exists(k_file):
            ks.append(np.loadtxt(k_file, dtype=np.float32))
        else:
            ks.append(_default_k(cfg.data.width, cfg.data.height))
    return SnippetDataset(seqs, ks, cfg.data.frame_offsets)


def make_training_eval_hook(cfg: ColvoConfig, model: torch.nn.Module):
    """Periodic during-training evaluation + image panels.

    Scores depth (Abs-Rel & co) and pose (ATE, RPE) on a held-out rendered
    sequence, and writes the panel set (colormapped disparity, automask,
    LCC-calibrated warp error) through ``writer.log_image``. The hook
    evaluates ``state.model`` (a restart replaces the model), on the
    device of ``model``, under ``torch.no_grad()`` in eval mode; its warp is
    the plain ``bilinear_sample``, so it launches no kernel.
    """
    device = next(model.parameters()).device
    seq = render_sequence(
        n_frames=16, height=cfg.data.height, width=cfg.data.width, seed=999
    )
    frames = torch.from_numpy(seq.frames).to(device)  # (N, H, W, 3)
    imgs = frames.permute(0, 3, 1, 2).contiguous()
    k = torch.from_numpy(seq.k).to(device)
    k_inv = torch.linalg.inv(k)
    offsets = cfg.data.frame_offsets
    mid = len(seq.frames) // 2
    snippet = frames[[mid] + [mid + o for o in offsets]][None]  # (1, 1+S, H, W, 3)
    m_cfg, l_cfg = cfg.model, cfg.loss

    @torch.no_grad()
    def _eval_fwd(net):
        # depth over the whole held-out sequence (batched)
        disps, bnecks = net.depth(imgs)
        pred_disp = disps[0][:, 0]
        # the pose probe: every consecutive pair in one batched call, with
        # the streaming executor's (prev, cur) + DCDP carry convention
        feats = [bnecks[:-1], bnecks[1:]] if m_cfg.dcdp_fusion else None
        aa, tr = net.pose(imgs[:-1], imgs[1:], feats)
        rel6 = torch.cat([aa, tr], dim=-1).float()
        _, pred_depth = disp_to_depth(pred_disp, m_cfg.min_depth, m_cfg.max_depth)
        # panel set on one snippet: disp, automask, warp error
        sdisps, poses = net(snippet)
        t_mats = poses_to_transforms(poses.float())
        disp0 = sdisps[0][0][..., 0]
        _, depth0 = disp_to_depth(disp0, m_cfg.min_depth, m_cfg.max_depth)
        tgt = snippet[:, 0]
        pts = backproject(depth0, k_inv)
        errs, ids = [], []
        for s in range(len(offsets)):
            pix, _ = project(pts, k, t_mats[:, s])
            warped = bilinear_sample(snippet[:, s + 1], pix)
            if l_cfg.lcc and l_cfg.lcc_mode != "off":
                vm = None
                if l_cfg.lcc_mode.startswith("global"):
                    vm = _valid_mask(pix, pix.shape[1], pix.shape[2])
                warped = lcc_calibrate(warped, tgt, l_cfg.lcc_mode, l_cfg.lcc_window,
                                       valid_mask=vm)
            errs.append(photometric_error(warped, tgt, l_cfg.ssim_alpha))
            ids.append(photometric_error(snippet[:, s + 1], tgt, l_cfg.ssim_alpha))
        warp_err_panel = errs[0][0]
        errs, ids = torch.stack(errs, -1), torch.stack(ids, -1)
        automask = (torch.amin(errs, -1) < torch.amin(ids, -1)).float()
        return pred_depth, disp0[0], automask[0], warp_err_panel, rel6

    def hook(step, state, writer):
        net = state.model
        was_training = net.training
        net.eval()
        try:
            out = _eval_fwd(net)
        finally:
            net.train(was_training)
        pred_depth, disp0, automask, warp_err, rel6 = (t.cpu().numpy() for t in out)
        metrics = compute_depth_errors(
            seq.depths, pred_depth, max_depth=cfg.eval.depth_cap,
            median_scaling=cfg.eval.median_scaling,
        )
        # trajectory quality during training: chain the probe's relative
        # poses and score ATE/RPE against the held-out sequence's GT
        metrics.update(evaluate_pose(chain_relative_poses(rel6), seq.poses))
        if writer is not None:
            writer.log_image(step, "panels/disp", colormap_depth(disp0))
            writer.log_image(step, "panels/automask",
                             np.repeat(automask[..., None], 3, axis=-1))
            we = warp_err / max(float(warp_err.max()), 1e-6)
            writer.log_image(step, "panels/warp_error",
                             np.repeat(we[..., None], 3, axis=-1))
        return {f"eval/{kk}": float(vv) for kk, vv in metrics.items()}

    return hook


def train(cfg: ColvoConfig, log_dir: str = "runs/train", max_steps: Optional[int] = None,
          resume: bool = False, device: str | torch.device = "cuda"):
    """Full DCDP+LCC training on ``device``. Returns (model, state)."""
    device = resolve_device(device)  # before the dataset is rendered
    dataset = build_dataset(cfg)
    return train_loop(cfg, dataset, log_dir=log_dir, max_steps=max_steps, resume=resume,
                      eval_hook_factory=make_training_eval_hook, device=device)


def make_runner(cfg: ColvoConfig, weights: Optional[str] = None,
                device: str | torch.device = "cuda") -> InferenceRunner:
    """An inference runner on ``device`` over exported ``.npz`` weights,
    or over the port's own init from ``train.seed`` (whose RNG differs from
    the reference's, so parity needs an ``.npz``)."""
    device = resolve_device(device)
    if weights:
        state_dict = load_npz(weights, cfg.model)
    else:
        model = ColVOModel(cfg.model)
        model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
        state_dict = model.state_dict()
    return InferenceRunner(cfg, state_dict, device=device)


def infer_depth(cfg: ColvoConfig, frames_path: str, out_dir: str,
                weights: Optional[str] = None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Depth maps (+ colormapped PNGs) for a frame dir/video: one
    ``runner.infer_depth`` call a frame, ``depth_<i>.png`` and
    ``depths.npy`` in ``out_dir``."""
    runner = make_runner(cfg, weights, device)
    src = open_source(frames_path, cfg.data.width, cfg.data.height)
    os.makedirs(out_dir, exist_ok=True)
    depths = []
    for i, frame in enumerate(src):
        depth, _ = runner.infer_depth(frame[None])
        depths.append(depth[0])
        write_png(os.path.join(out_dir, f"depth_{i:06d}.png"),
                  (colormap_depth(depth[0]) * 255).astype(np.uint8))
    np.save(os.path.join(out_dir, "depths.npy"), np.stack(depths))
    return np.stack(depths)


def run_vo_pipeline(
    cfg: ColvoConfig,
    frames_path: Optional[str] = None,
    out_dir: str = "runs/vo",
    weights: Optional[str] = None,
    reconstruct: bool = True,
    device: str | torch.device = "cuda",
) -> VOResult:
    """Streamed VO → ``trajectory.npy`` and ``trajectory.png`` (+ the
    stitched ``reconstruction.ply`` and ``reconstruction.png``). Without
    ``frames_path`` it runs on a 48-frame rendered demo sequence."""
    runner = make_runner(cfg, weights, device)
    os.makedirs(out_dir, exist_ok=True)
    if frames_path is None:  # synthetic demo sequence
        seq = render_sequence(n_frames=48, height=cfg.data.height, width=cfg.data.width)
        frames = list(seq.frames)
        k = seq.k
    else:
        # uint8 on the wire: the streaming executor normalizes on device
        src = open_source(frames_path, cfg.data.width, cfg.data.height, pixel_format="rgb8")
        frames = list(src)
        k = _default_k(cfg.data.width, cfg.data.height)
    vo = run_vo(runner, frames, keyframe_every=2)
    np.save(os.path.join(out_dir, "trajectory.npy"), vo.poses)
    if reconstruct:
        cloud = stitch_pointclouds(vo, k, frames=frames, voxel=0.002,
                                   max_depth=cfg.model.max_depth)
        save_ply(cloud, os.path.join(out_dir, "reconstruction.ply"))
        viz_recon(cloud.points, os.path.join(out_dir, "reconstruction.png"),
                  colors=cloud.colors, trajectory=vo.poses[:, :3, 3])
    viz_trajectory({"ColVO(ours)": vo.poses[:, :3, 3]},
                   os.path.join(out_dir, "trajectory.png"))
    return vo


def evaluate_synthetic(
    cfg: ColvoConfig,
    weights: Optional[str] = None,
    out_dir: str = "runs/eval",
    n_frames: int = 48,
    exposure_jitter: float = 0.0,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Full evaluation on a held-out rendered sequence: depth metrics, ATE,
    polyp errors, the reconstruction and the three reference figure types.

    ``exposure_jitter``: per-frame auto-exposure gain on the eval sequence,
    so the LCC ablation evaluates under the nuisance it trains with."""
    runner = make_runner(cfg, weights, device)
    os.makedirs(out_dir, exist_ok=True)
    seq = render_sequence(
        n_frames=n_frames, height=cfg.data.height, width=cfg.data.width,
        seed=999, exposure_jitter=exposure_jitter,
    )
    # depth
    depth_metrics, preds = evaluate_depth(runner, seq.frames, seq.depths, cfg)
    viz_depth_grid(
        seq.frames[0], seq.depths[0], {"ColVO(ours)": preds[0]},
        os.path.join(out_dir, "qualitative_depth.png"),
        max_depth=cfg.eval.depth_cap,
    )
    # pose
    vo = run_vo(runner, list(seq.frames), keyframe_every=1)
    pose_metrics = evaluate_pose(vo.poses, seq.poses.astype(np.float64))
    aligned = align_trajectory(vo.poses[:, :3, 3], seq.poses[:, :3, 3])
    viz_trajectory(
        {"Ground Truth": seq.poses[:, :3, 3], "ColVO(ours)": aligned},
        os.path.join(out_dir, "trajectory_predictions.png"),
    )
    # polyp localization: synthetic detections whose GT 3-D position is
    # exact (GT depth lifted through GT pose); the VO result is sim(3)-
    # aligned first (monocular scale), its depth maps scaled by the same s
    rng = np.random.default_rng(5)
    h, w = cfg.data.height, cfg.data.width
    k_inv64 = np.linalg.inv(seq.k.astype(np.float64))
    dets, gts = [], []
    for fid in (n_frames // 4, n_frames // 2, 3 * n_frames // 4):
        cx = int(rng.integers(w // 4, 3 * w // 4))
        cy = int(rng.integers(h // 4, 3 * h // 4))
        dets.append(PolypDetection(frame_id=fid, box=(cx - 6, cy - 6, cx + 6, cy + 6)))
        d_gt = float(seq.depths[fid][cy, cx])
        p_cam = k_inv64 @ np.array([cx, cy, 1.0]) * d_gt
        pose = seq.poses[fid].astype(np.float64)
        gts.append(pose[:3, :3] @ p_cam + pose[:3, 3])
    rot, tvec, s = umeyama(vo.poses[:, :3, 3], seq.poses[:, :3, 3])
    apose = vo.poses.astype(np.float64).copy()
    apose[:, :3, 3] = (s * (rot @ vo.poses[:, :3, 3].T)).T + tvec
    apose[:, :3, :3] = rot @ vo.poses[:, :3, :3]
    vo_aligned = VOResult(
        poses=apose, depths=[d * s for d in vo.depths], keyframe_ids=vo.keyframe_ids
    )
    locs = localize_polyps(vo_aligned, seq.k, dets, np.stack(gts))
    # figure markers live in the (unaligned) network frame of the cloud
    locs_fig = localize_polyps(vo, seq.k, dets)
    polyp_metrics = {
        f"polyp/e{i+1}": float(loc.error) for i, loc in enumerate(locs)
    }
    polyp_metrics["polyp/e_mean"] = float(np.mean([loc.error for loc in locs]))
    # reconstruction
    cloud = stitch_pointclouds(vo, seq.k, frames=list(seq.frames), voxel=0.002,
                               max_depth=cfg.model.max_depth)
    save_ply(cloud, os.path.join(out_dir, "reconstruction.ply"))
    viz_recon(cloud.points, os.path.join(out_dir, "colon_reconstruction.png"),
              colors=cloud.colors, trajectory=vo.poses[:, :3, 3],
              polyps=np.stack([loc.position_world for loc in locs_fig]),
              polyp_errors=[loc.error for loc in locs])
    metrics = {**depth_metrics, **pose_metrics, **polyp_metrics}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def evaluate_dataset(
    cfg: ColvoConfig,
    data_root: str,
    weights: Optional[str] = None,
    out_dir: str = "runs/eval",
    sequences: Optional[Sequence[str]] = None,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Evaluate on a VCD/CSD-style benchmark directory (layout in
    :mod:`colvo_torch.data.benchmark`). Per sequence: the 7 depth metrics
    against dense GT (median scaling + cap), ATE/RPE after sim(3) alignment
    where GT poses exist, and the depth-grid and trajectory figures of the
    first sequence that has each GT. Returns per-sequence (``<name>/depth/*``,
    ``<name>/pose/*``) and ``mean/`` metrics; writes ``metrics.json`` and
    the figures to ``out_dir``."""
    runner = make_runner(cfg, weights, device)
    os.makedirs(out_dir, exist_ok=True)
    names = list(sequences) if sequences else list_sequences(data_root)
    if not names:
        raise FileNotFoundError(f"no sequences under {data_root}")

    metrics: Dict[str, float] = {}
    depth_accum: Dict[str, List[float]] = {}
    pose_accum: Dict[str, List[float]] = {}
    need_depth_fig = True
    need_pose_fig = True
    for name in names:
        seq = load_benchmark_sequence(
            os.path.join(data_root, name), cfg.data.width, cfg.data.height
        )
        vo = None
        if seq.gt_poses is not None:
            # One coupled streaming pass covers both evaluations: its
            # per-frame depth maps (float16 wire, ~5e-4 relative) feed the
            # depth metrics below, so the depth network runs once.
            vo = run_vo(runner, list(seq.frames), keyframe_every=1)
            pm = evaluate_pose(vo.poses, seq.gt_poses)
            for k, v in pm.items():
                metrics[f"{name}/pose/{k}"] = v
                pose_accum.setdefault(k, []).append(v)
            if need_pose_fig:
                aligned = align_trajectory(vo.poses[:, :3, 3], seq.gt_poses[:, :3, 3])
                viz_trajectory(
                    {"Ground Truth": seq.gt_poses[:, :3, 3], "ColVO(ours)": aligned},
                    os.path.join(out_dir, f"trajectory_{name}.png"),
                )
                need_pose_fig = False
        if seq.gt_depths is not None:
            if vo is not None and len(vo.depths) == len(seq.frames):
                preds = np.stack(vo.depths)
                dm = compute_depth_errors(
                    seq.gt_depths, preds, max_depth=cfg.eval.depth_cap,
                    median_scaling=cfg.eval.median_scaling,
                )
            else:
                dm, preds = evaluate_depth(runner, seq.frames, seq.gt_depths, cfg)
            for k, v in dm.items():
                metrics[f"{name}/depth/{k}"] = v
                depth_accum.setdefault(k, []).append(v)
            if need_depth_fig:
                viz_depth_grid(
                    seq.frames[0], seq.gt_depths[0], {"ColVO(ours)": preds[0]},
                    os.path.join(out_dir, f"qualitative_depth_{name}.png"),
                    max_depth=cfg.eval.depth_cap,
                )
                need_depth_fig = False
    for k, vs in depth_accum.items():
        metrics[f"mean/depth/{k}"] = float(np.mean(vs))
    for k, vs in pose_accum.items():
        metrics[f"mean/pose/{k}"] = float(np.mean(vs))
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics
