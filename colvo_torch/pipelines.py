"""High-level pipelines (port of the training part of ``colvo/pipelines.py``):
the dataset factory, the training eval hook and ``train``, callable from
Python or through ``python -m colvo_torch.cli train``.

The inference, VO and evaluation pipelines are not ported yet
(``ROADMAP.md`` §A.3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence, synthetic_dataset
from colvo_torch.evaluation import compute_depth_errors, evaluate_pose
from colvo_torch.evaluation.viz import colormap_depth
from colvo_torch.geometry import backproject, bilinear_sample, disp_to_depth, project
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.losses import lcc_calibrate, photometric_error, poses_to_transforms
from colvo_torch.runtime.loop import train as train_loop
from colvo_torch.vo.driver import chain_relative_poses


def build_dataset(cfg: ColvoConfig) -> SnippetDataset:
    """Dataset factory: synthetic renders. Frame directories and videos
    wait for the port of ``data/sources.py`` (ROADMAP.md §A.3)."""
    if cfg.data.dataset == "synthetic":
        return synthetic_dataset(cfg.data)
    raise NotImplementedError(
        f"data.dataset={cfg.data.dataset!r}: frame sources (data/sources.py) are not "
        "ported yet (ROADMAP.md §A.3); only 'synthetic' is")


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
