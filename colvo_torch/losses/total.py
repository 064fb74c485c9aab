"""Multi-scale total training loss (port of ``colvo/losses/total.py``).

The default DCDP+LCC objective over a snippet: for each scale and source
frame, disp→depth, backprojection, SE(3), projection and the bilinear warp
(kernel S), LCC calibration and SSIM+L1 at full resolution (Monodepth2
protocol), then min-reprojection + automask, edge-aware smoothness, the
native-scale geometric-consistency term with gradients through both the
projected z and the sampled source depth (kernels S and T), and the
depth↔pose gauge hinge. Aux keys are those of the JAX loss.

Two alternative photometric paths of the reference are ported:
``loss.fused_kernel`` (each warp + LCC + SSIM + L1 by the fused kernel F)
and ``loss.batched_photo`` (all n_scales × n_sources warps in one grouped
launch of S, then one stats pipeline over the stack). The other knobs off
by default in the reference (``photo_native``, ``geo_full_res``,
``geo_grad="sym"``, ``geo_stopgrad``, ``compute_dtype``, ``photo_remat``,
``scatter_audit``) raise ``NotImplementedError`` naming the knob.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from colvo_torch.config import LossConfig, ModelConfig
from colvo_torch.geometry import (
    backproject,
    disp_to_depth,
    project,
    transformation_from_parameters,
)
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.kernels import (
    bilinear_sample_full_multi,
    bilinear_sample_grouped_planes,
    bilinear_sample_planes,
    warp_photometric,
)
from colvo_torch.losses.photometric import lcc_calibrate, photometric_error
from colvo_torch.losses.terms import automask as automask_fn
from colvo_torch.losses.terms import geometry_consistency, smoothness_loss
from colvo_torch.models.depth_decoder import upsample_nearest

# Off-default knobs of the reference whose branches are not ported, with
# the value that keeps the default path.
_UNPORTED = {
    "photo_native": False,
    "geo_full_res": False,
    "geo_stopgrad": False,
    "photo_remat": False,
    "scatter_audit": False,
}


def _check_config(cfg: LossConfig) -> None:
    if cfg.geo_grad not in ("both", "sym"):
        raise ValueError(f"loss.geo_grad must be 'both' or 'sym', got {cfg.geo_grad!r}")
    if cfg.fused_kernel and cfg.batched_photo:
        raise ValueError(
            "loss.fused_kernel and loss.batched_photo are alternative "
            "launch-reduction strategies for the same photometric path — pick one"
        )
    if cfg.fused_kernel and cfg.compute_dtype not in ("", "float32"):
        raise ValueError(
            "loss.compute_dtype is not supported with loss.fused_kernel "
            "(the fused kernel computes every photometric plane in float32)"
        )
    if cfg.compute_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(
            f"loss.compute_dtype must be ''|float32|bfloat16, got {cfg.compute_dtype!r}"
        )
    unported = [f"{k}={getattr(cfg, k)!r}" for k, v in _UNPORTED.items() if getattr(cfg, k) != v]
    if cfg.geo_grad != "both":
        unported.append(f"geo_grad={cfg.geo_grad!r}")
    if cfg.compute_dtype not in ("", "float32"):
        unported.append(f"compute_dtype={cfg.compute_dtype!r}")
    if unported:
        raise NotImplementedError(
            "loss knobs not ported yet: " + ", ".join(f"loss.{u}" for u in unported)
        )


def _scale_k(k: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale (…, 3, 3) intrinsics for a resized grid."""
    return torch.stack([k[..., 0, :] * sx, k[..., 1, :] * sy, k[..., 2, :]], dim=-2)


def _halve(x: torch.Tensor) -> torch.Tensor:
    """2× mean-pool of a (B, H, W, C) map."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _upsample_to(disp: torch.Tensor, height: int) -> torch.Tensor:
    factor = height // disp.shape[1]
    return disp if factor == 1 else upsample_nearest(disp, factor)


def poses_to_transforms(poses: torch.Tensor) -> torch.Tensor:
    """(B, S, 6) raw pose params → (B, S, 4, 4) target→source transforms."""
    return transformation_from_parameters(poses[..., :3], poses[..., 3:])


def snippet_loss(
    disps: List[Dict[int, torch.Tensor]],
    poses: torch.Tensor,
    frames: torch.Tensor,
    k: torch.Tensor,
    k_inv: torch.Tensor,
    loss_cfg: LossConfig,
    model_cfg: ModelConfig,
    frames_clean: torch.Tensor | None = None,
    geo_scale: torch.Tensor | float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total self-supervised loss over one snippet batch.

    disps: per-frame {scale: (B, h, w, 1)} (index 0 = target); poses
    (B, S, 6) target→source; frames (B, 1+S, H, W, 3) network inputs;
    k / k_inv (3, 3) full-resolution intrinsics; frames_clean the
    un-jittered copies for the photometric comparison (default ``frames``).
    Returns (scalar loss, aux dict of per-term scalars + full-res depth).
    """
    _check_config(loss_cfg)
    if frames.ndim != 5 or poses.ndim != 3 or poses.shape[-1] != 6:
        raise ValueError(f"bad shapes frames {tuple(frames.shape)} poses {tuple(poses.shape)}")
    if poses.shape[1] != frames.shape[1] - 1:
        raise ValueError("poses must have one entry per source frame")
    if frames_clean is None:
        frames_clean = frames
    _, n_frames, height, width, _ = frames.shape
    n_sources = n_frames - 1
    tgt_clean = frames_clean[:, 0]
    # Channel planes of the clean frames for kernel S: (B, F, 3, H, W).
    planes = frames_clean.permute(0, 1, 4, 2, 3).contiguous()

    t_mats = poses_to_transforms(poses)

    lcc_mode = loss_cfg.lcc_mode if loss_cfg.lcc and loss_cfg.lcc_mode != "off" else "off"

    def _ident_src(src_f, tgt_f):
        if loss_cfg.lcc_identity and lcc_mode != "off":
            return lcc_calibrate(src_f, tgt_f, lcc_mode, loss_cfg.lcc_window)
        return src_f

    if loss_cfg.automask:
        identity_errors = torch.stack(
            [
                photometric_error(
                    _ident_src(frames_clean[:, s + 1], tgt_clean), tgt_clean,
                    loss_cfg.ssim_alpha,
                )
                for s in range(n_sources)
            ],
            dim=-1,
        )

    n_scales = model_cfg.n_scales
    photo_total = 0.0
    smooth_total = 0.0
    geo_total = 0.0
    full_depth = None

    # Projection pass at full resolution (the photometric grid).
    pix_all: List[List[torch.Tensor]] = []
    z_all: List[List[torch.Tensor]] = []
    for scale in range(n_scales):
        disp_full = _upsample_to(disps[0][scale], height)
        _, depth = disp_to_depth(disp_full[..., 0], model_cfg.min_depth, model_cfg.max_depth)
        if scale == 0:
            full_depth = depth
        cam_points = backproject(depth, k_inv)
        projected = [project(cam_points, k, t_mats[:, s]) for s in range(n_sources)]
        pix_all.append([p for p, _ in projected])
        z_all.append([z for _, z in projected])

    def photometric_of(s: int, pix: torch.Tensor) -> torch.Tensor:
        if loss_cfg.fused_kernel:
            return warp_photometric(planes[:, s + 1], planes[:, 0], pix[..., 0], pix[..., 1],
                                    lcc_mode, loss_cfg.lcc_window, loss_cfg.ssim_alpha)
        warped = bilinear_sample_planes(planes[:, s + 1], pix[..., 0], pix[..., 1])
        warped = warped.permute(0, 2, 3, 1)
        if lcc_mode.startswith("global"):
            # Global LCC moments must not pool border-clamped samples.
            vmask = _valid_mask(pix, pix.shape[1], pix.shape[2])
            warped = lcc_calibrate(warped, tgt_clean, lcc_mode, loss_cfg.lcc_window,
                                   valid_mask=vmask)
        elif lcc_mode != "off":
            warped = lcc_calibrate(warped, tgt_clean, lcc_mode, loss_cfg.lcc_window)
        return photometric_error(warped, tgt_clean, loss_cfg.ssim_alpha)

    # batched_photo: all n_scales × n_sources full-resolution warps in one
    # grouped launch of S and one stats pipeline over the stack.
    err_lookup: Dict[Tuple[int, int], torch.Tensor] = {}
    if loss_cfg.batched_photo:
        batch = frames.shape[0]
        # plane j = s·B + b; coords scale-minor, so plane i samples source i // n_scales
        src_one = torch.cat([planes[:, s + 1] for s in range(n_sources)])
        pix_flat = torch.stack(
            [torch.cat([pix_all[sc][s] for s in range(n_sources)]) for sc in range(n_scales)],
            dim=1,
        ).reshape(-1, height, width, 2)
        warped = bilinear_sample_grouped_planes(src_one, pix_flat[..., 0], pix_flat[..., 1],
                                                n_scales)
        warped = warped.permute(0, 2, 3, 1).reshape(n_sources, batch, n_scales, height, width, 3)
        tgt_b = tgt_clean[None, :, None]  # broadcast over sources and scales
        vmask = None
        if lcc_mode.startswith("global"):
            vmask = _valid_mask(pix_flat, height, width).reshape(
                n_sources, batch, n_scales, height, width)
        if lcc_mode != "off":
            warped = lcc_calibrate(warped, tgt_b, lcc_mode, loss_cfg.lcc_window,
                                   valid_mask=vmask)
        err_g = photometric_error(warped, tgt_b, loss_cfg.ssim_alpha)
        for sc in range(n_scales):
            for s in range(n_sources):
                err_lookup[(sc, s)] = err_g[s, :, sc]

    def _geo_grid(scale: int, s: int):
        """Native-scale geo grid for one source:
        (pix_g, z_g, src_depth_g, h_g, w_g)."""
        g_disp_t = disps[0][scale]
        g_disp_s = disps[s + 1][scale]
        if loss_cfg.geo_res_cap > 0:
            while g_disp_t.shape[1] > loss_cfg.geo_res_cap:
                g_disp_t = _halve(g_disp_t)
                g_disp_s = _halve(g_disp_s)
        h_g, w_g = g_disp_t.shape[1], g_disp_t.shape[2]
        k_g = _scale_k(k, w_g / width, h_g / height)
        _, depth_g = disp_to_depth(g_disp_t[..., 0], model_cfg.min_depth, model_cfg.max_depth)
        _, src_depth_g = disp_to_depth(
            g_disp_s[..., 0], model_cfg.min_depth, model_cfg.max_depth
        )
        pix_g, z_g = project(backproject(depth_g, torch.linalg.inv_ex(k_g).inverse), k_g, t_mats[:, s])
        return pix_g, z_g, src_depth_g, h_g, w_g

    # Geo pass: every scale's depth warps in one sampler launch (and one
    # scatter launch in the backward). At one scale the per-source warps
    # are shape-identical and stack on the batch axis; the scales are
    # separate plane sets of the same launch. Exact: both kernels act on
    # each plane on its own.
    geo_grids: List[List[tuple]] = []
    geo_sampled: List[Tuple[torch.Tensor, ...]] = []
    if loss_cfg.geometric_weight > 0:
        geo_grids = [[_geo_grid(scale, s) for s in range(n_sources)] for scale in range(n_scales)]
        pix_stacks = [torch.cat([g[0] for g in grids]) for grids in geo_grids]
        samp = bilinear_sample_full_multi(
            [torch.cat([g[2] for g in grids])[:, None] for grids in geo_grids],
            [pix[..., 0] for pix in pix_stacks], [pix[..., 1] for pix in pix_stacks])
        geo_sampled = [torch.chunk(sm[:, 0], n_sources) for sm in samp]

    for scale in range(n_scales):
        disp_s = disps[0][scale]

        warped_errors = []
        geo_losses = []
        for s in range(n_sources):
            pix, z = pix_all[scale][s], z_all[scale][s]
            valid = _valid_mask(pix, height, width) * (z > 0)
            err = err_lookup[(scale, s)] if loss_cfg.batched_photo else photometric_of(s, pix)
            if loss_cfg.geometric_weight > 0:
                pix_g, z_g, _, h_g, w_g = geo_grids[scale][s]
                gvalid = _valid_mask(pix_g, h_g, w_g)
                g_loss, g_weight = geometry_consistency(
                    z_g, geo_sampled[scale][s], gvalid, behind=z_g <= 0
                )
                if height // h_g > 1:
                    up = height // h_g
                    g_weight = upsample_nearest(g_weight[..., None], up)[..., 0]
                    gvalid = upsample_nearest(gvalid[..., None], up)[..., 0]
                geo_losses.append(g_loss)
                # Downweight photometrically where geometry disagrees
                # (occlusion/dynamic) — the DCDP loss-level coupling.
                err = err * g_weight + err * (1.0 - gvalid * valid)
            warped_errors.append(err)

        errors = torch.stack(warped_errors, dim=-1)  # (B, H, W, S)
        if loss_cfg.automask:
            min_err, mask = automask_fn(errors, identity_errors)
            photo = torch.sum(min_err * mask) / (torch.sum(mask) + 1e-7)
        elif loss_cfg.min_reprojection:
            photo = torch.mean(torch.amin(errors, dim=-1))
        else:
            photo = torch.mean(errors)

        tgt_small = tgt_clean[:, :: 2**scale, :: 2**scale]
        smooth = smoothness_loss(disp_s, tgt_small) / (2**scale)

        photo_total = photo_total + photo
        smooth_total = smooth_total + smooth
        if geo_losses:
            geo_total = geo_total + sum(geo_losses) / len(geo_losses)

    photo_total = photo_total / n_scales
    smooth_total = smooth_total / n_scales
    if loss_cfg.geometric_weight > 0:
        geo_total = geo_total / n_scales
    else:
        geo_total = torch.zeros((), dtype=photo_total.dtype, device=photo_total.device)

    total = (
        photo_total
        + loss_cfg.smoothness_weight * smooth_total
        + loss_cfg.geometric_weight * geo_scale * geo_total
    )

    aux: Dict[str, torch.Tensor] = {}
    # Depth<->pose gauge hinge on r = mean||t|| / mean(depth): zero value
    # and gradient inside [gauge_lo, gauge_hi].
    if loss_cfg.gauge_weight > 0:
        t_mag = torch.mean(torch.linalg.norm(poses[..., 3:].float(), dim=-1))
        d_mean = torch.mean(full_depth.float())
        log_r = torch.log(t_mag + 1e-12) - torch.log(d_mean + 1e-12)
        lo = math.log(loss_cfg.gauge_lo)
        hi = math.log(loss_cfg.gauge_hi)
        gauge = torch.square(torch.clamp(lo - log_r, min=0.0)) + torch.square(
            torch.clamp(log_r - hi, min=0.0)
        )
        total = total + loss_cfg.gauge_weight * gauge
        aux["loss/gauge"] = gauge
        aux["gauge/r"] = torch.exp(log_r)
    aux["loss/photometric"] = photo_total
    aux["loss/smoothness"] = smooth_total
    aux["loss/geometric"] = geo_total
    aux["loss/total"] = total
    aux["depth/full"] = full_depth
    return total, aux
