"""Multi-scale total training loss (port of ``colvo/losses/total.py``).

The default DCDP+LCC objective over a snippet: for each scale and source
frame, disp→depth, backprojection, SE(3) and projection (kernel P, one
call a grid for all its sources), the bilinear warp (kernel S), LCC
calibration and SSIM+L1 at full resolution (Monodepth2
protocol), then min-reprojection + automask, edge-aware smoothness, the
native-scale geometric-consistency term with gradients through both the
projected z and the sampled source depth (kernels S and T), and the
depth↔pose gauge hinge. Aux keys are those of the JAX loss.

Every knob of the reference's ``LossConfig`` is ported, each with the
reference's ``ValueError`` for the combinations it refuses, in its order:

* photometric path: ``fused_kernel`` (each warp + LCC + SSIM + L1 by the
  fused kernel F), ``batched_photo`` (all n_scales × n_sources warps in
  one grouped launch of S, then one stats pipeline over the stack),
  ``photo_native`` (each scale's photometric term on its own grid, against
  2×-mean-pooled frame pyramids, with a rescaled K and per-scale identity
  errors), ``photo_remat`` (LCC + SSIM + L1 under ``torch.utils.checkpoint``;
  the warp stays outside, so S never re-runs in the backward) and
  ``compute_dtype="bfloat16"`` (the comparison planes after the float32
  gather in bf16, the reductions in float32);
* geometric term: the default native-scale protocol (one S launch for
  every scale's plane set, one T launch for their source cotangents),
  ``geo_res_cap``, ``geo_full_res`` (every scale at full resolution, T over
  four full-resolution plane sets), ``geo_stopgrad`` (detached source
  depths: S runs, T does not) and ``geo_grad="sym"`` (both warp directions
  a pair, each sampling the other frame's detached depth, the reverse one
  through the inverse pose; the mean of the two losses: 2 × n_scales plane
  sets in one S launch, no T);
* ``scatter_audit``: ``aux["geo/scatter_overflow"]``, the reference's
  count of offset classes its TPU scatter kernel would drop. T drops
  nothing for any warp (``kernels/csrc/scatter.cu``), so the port's value
  is a float32 zero by construction.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from colvo_torch.config import LossConfig, ModelConfig
from colvo_torch.geometry import disp_to_depth, transformation_from_parameters
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.kernels import (
    bilinear_sample_full_multi,
    bilinear_sample_grouped_planes,
    bilinear_sample_planes,
    project_depth,
)
from colvo_torch.losses.photometric import lcc_calibrate, photometric_error, warp_photometric
from colvo_torch.losses.terms import LOCAL
from colvo_torch.losses.terms import automask as automask_fn
from colvo_torch.losses.terms import geometry_consistency, smoothness_loss
from colvo_torch.models.depth_decoder import upsample_nearest


def _check_config(cfg: LossConfig) -> None:
    """The reference's refusals, in its order (``colvo/losses/total.py``)."""
    if cfg.geo_grad not in ("both", "sym"):
        raise ValueError(f"loss.geo_grad must be 'both' or 'sym', got {cfg.geo_grad!r}")
    if cfg.geo_grad == "sym" and cfg.geo_full_res:
        raise ValueError(
            "loss.geo_grad='sym' is only defined for the native-scale protocol "
            "(geo_full_res=False)"
        )
    if cfg.photo_native and cfg.geo_full_res:
        raise ValueError(
            "loss.photo_native (scale-native photometric) contradicts "
            "loss.geo_full_res (full-res geometry) — pick one protocol"
        )
    if cfg.photo_native and cfg.batched_photo:
        raise ValueError(
            "loss.batched_photo stacks shape-identical full-res evaluations; "
            "incompatible with loss.photo_native"
        )
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


def _scale_k(k: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Rescale (…, 3, 3) intrinsics for a resized grid."""
    return torch.stack([k[..., 0, :] * sx, k[..., 1, :] * sy, k[..., 2, :]], dim=-2)


def _inside(x: torch.Tensor, y: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``_valid_mask`` of the coordinate planes x, y."""
    return _valid_mask(torch.stack((x, y), dim=-1), height, width)


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
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total self-supervised loss over one snippet batch.

    disps: per-frame {scale: (B, h, w, 1)} (index 0 = target); poses
    (B, S, 6) target→source; frames (B, 1+S, H, W, 3) network inputs;
    k / k_inv (3, 3) full-resolution intrinsics; frames_clean the
    un-jittered copies for the photometric comparison (default ``frames``).
    ``mesh`` (``runtime.mesh.Mesh``) makes every batch-level reduction
    global over the data-parallel ranks, whose rows together are the
    batch; without it they are this process's ``torch.sum``/``torch.mean``.
    Returns (scalar loss, aux dict of per-term scalars + full-res depth).
    """
    _check_config(loss_cfg)
    red = LOCAL if mesh is None else mesh
    if frames.ndim != 5 or poses.ndim != 3 or poses.shape[-1] != 6:
        raise ValueError(f"bad shapes frames {tuple(frames.shape)} poses {tuple(poses.shape)}")
    if poses.shape[1] != frames.shape[1] - 1:
        raise ValueError("poses must have one entry per source frame")
    if frames_clean is None:
        frames_clean = frames
    _, n_frames, height, width, _ = frames.shape
    n_sources = n_frames - 1
    n_scales = model_cfg.n_scales
    tgt_clean = frames_clean[:, 0]

    t_mats = poses_to_transforms(poses)

    # loss.compute_dtype: every comparison plane after the float32 gather
    # (LCC/SSIM statistics, error maps, identity stacks) in bf16; geometry
    # and the final reductions stay float32.
    cdt = torch.bfloat16 if loss_cfg.compute_dtype == "bfloat16" else None
    _c = (lambda x: x.to(cdt)) if cdt is not None else (lambda x: x)

    # Frames for each scale's photometric term, NHWC and as channel planes
    # for kernels S and F: full resolution at every scale by default, the
    # 2^s-mean-pooled pyramid under photo_native.
    tgt_pyr = [tgt_clean]
    src_pyr = [[frames_clean[:, s + 1] for s in range(n_sources)]]
    if loss_cfg.photo_native:
        for _ in range(n_scales - 1):
            tgt_pyr.append(_halve(tgt_pyr[-1]))
            src_pyr.append([_halve(x) for x in src_pyr[-1]])
        # (the target's planes only for F)
        tgt_planes = [t.permute(0, 3, 1, 2).contiguous() if loss_cfg.fused_kernel else None
                      for t in tgt_pyr]
        src_planes = [[x.permute(0, 3, 1, 2).contiguous() for x in xs] for xs in src_pyr]
    else:
        # (B, F, 3, H, W): the frame slices need no copy
        planes = frames_clean.permute(0, 1, 4, 2, 3).contiguous()
        tgt_planes = [planes[:, 0]]
        src_planes = [[planes[:, s + 1] for s in range(n_sources)]]

    def _at(pyr, scale):
        return pyr[scale] if loss_cfg.photo_native else pyr[0]

    lcc_mode = loss_cfg.lcc_mode if loss_cfg.lcc and loss_cfg.lcc_mode != "off" else "off"

    def _ident_src(src_f, tgt_f):
        if loss_cfg.lcc_identity and lcc_mode != "off":
            return _c(lcc_calibrate(src_f, tgt_f, lcc_mode, loss_cfg.lcc_window))
        return _c(src_f)

    identity: List[torch.Tensor] = []  # per scale under photo_native, else one
    if loss_cfg.automask:
        for sc in range(n_scales if loss_cfg.photo_native else 1):
            identity.append(torch.stack(
                [photometric_error(_ident_src(src_pyr[sc][s], tgt_pyr[sc]), _c(tgt_pyr[sc]),
                                   loss_cfg.ssim_alpha) for s in range(n_sources)], dim=-1))

    full_depth = None

    # Projection pass: at full resolution (the photometric grid) by
    # default; on each scale's own grid with a rescaled K under
    # photo_native, where the geo term may reuse it. Each grid to every
    # source in one call (kernel P on the card): x, y and z as (S·B, h, w)
    # planes, plane s·B + b, the layout the samplers read.
    batch = frames.shape[0]
    t_src = t_mats.transpose(0, 1)  # (S, B, 4, 4)

    def _of(planes: torch.Tensor, s: int) -> torch.Tensor:
        return planes[s * batch:(s + 1) * batch]

    proj_all: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    depth_all: List[torch.Tensor] = []
    for scale in range(n_scales):
        if loss_cfg.photo_native:
            disp_n = disps[0][scale]
            h_s, w_s = disp_n.shape[1], disp_n.shape[2]
            k_s = _scale_k(k, w_s / width, h_s / height)
            k_inv_s = torch.linalg.inv_ex(k_s).inverse
            _, depth = disp_to_depth(disp_n[..., 0], model_cfg.min_depth, model_cfg.max_depth)
        else:
            disp_full = _upsample_to(disps[0][scale], height)
            k_s, k_inv_s = k, k_inv
            _, depth = disp_to_depth(disp_full[..., 0], model_cfg.min_depth, model_cfg.max_depth)
        if scale == 0:
            full_depth = depth
        depth_all.append(depth)
        proj_all.append(project_depth(depth, k_s, k_inv_s, t_src))

    def _stats_err(warped, tgt_f, vmask):
        if lcc_mode != "off":
            warped = lcc_calibrate(warped, tgt_f, lcc_mode, loss_cfg.lcc_window,
                                   valid_mask=vmask)
        return photometric_error(warped, tgt_f, loss_cfg.ssim_alpha)

    def stats_err(warped, tgt_f, vmask=None):
        if loss_cfg.photo_remat:
            # the statistics recomputed in the backward; their input, the
            # warp, is saved, so S never re-runs. No random numbers are
            # drawn, so the RNG state is not kept (a CUDA graph can
            # capture it).
            return checkpoint(_stats_err, warped, tgt_f, vmask, use_reentrant=False,
                              preserve_rng_state=False)
        return _stats_err(warped, tgt_f, vmask)

    def photometric_of(scale: int, s: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        src_p, tgt_p = _at(src_planes, scale)[s], _at(tgt_planes, scale)
        if loss_cfg.fused_kernel:
            return warp_photometric(src_p, tgt_p, x, y,
                                    lcc_mode, loss_cfg.lcc_window, loss_cfg.ssim_alpha)
        warped = _c(bilinear_sample_planes(src_p, x, y).permute(0, 2, 3, 1))
        # Global LCC moments must not pool border-clamped samples.
        vmask = _inside(x, y, x.shape[1], x.shape[2]) if lcc_mode.startswith("global") else None
        return stats_err(warped, _c(_at(tgt_pyr, scale)), vmask)

    # batched_photo: all n_scales × n_sources full-resolution warps in one
    # grouped launch of S and one stats pipeline over the stack.
    err_lookup: Dict[Tuple[int, int], torch.Tensor] = {}
    if loss_cfg.batched_photo:
        # plane j = s·B + b; coords scale-minor, so plane i samples source i // n_scales
        src_one = torch.cat(src_planes[0])
        x_flat, y_flat = (torch.stack([proj_all[sc][i] for sc in range(n_scales)], dim=1)
                          .reshape(-1, height, width) for i in (0, 1))
        warped = bilinear_sample_grouped_planes(src_one, x_flat, y_flat, n_scales)
        warped = _c(warped.permute(0, 2, 3, 1).reshape(n_sources, batch, n_scales, height,
                                                        width, 3))
        tgt_b = _c(tgt_clean)[None, :, None]  # broadcast over sources and scales
        vmask = None
        if lcc_mode.startswith("global"):
            vmask = _inside(x_flat, y_flat, height, width).reshape(
                n_sources, batch, n_scales, height, width)
        err_g = stats_err(warped, tgt_b, vmask)
        for sc in range(n_scales):
            for s in range(n_sources):
                err_lookup[(sc, s)] = err_g[s, :, sc]

    def _geo_grid(scale: int):
        """The geo grid of one scale, for every source: (x_g, y_g, z_g,
        src_depth_g) as (S·B, h_g, w_g) planes, then depth_g, h_g, w_g."""
        def depth_of(disp):
            return disp_to_depth(disp[..., 0], model_cfg.min_depth, model_cfg.max_depth)[1]

        if loss_cfg.geo_full_res:
            # full-resolution protocol: the photometric projection, the
            # source depth upsampled to the input grid
            src_depth_g = torch.cat([depth_of(_upsample_to(disps[s + 1][scale], height))
                                     for s in range(n_sources)])
            return (*proj_all[scale], src_depth_g, None, height, width)
        if loss_cfg.photo_native and loss_cfg.geo_res_cap == 0:
            # photo_native projected on this very grid: reuse it
            src_depth_g = torch.cat([depth_of(disps[s + 1][scale]) for s in range(n_sources)])
            depth_g = depth_all[scale]
            return (*proj_all[scale], src_depth_g, depth_g, *depth_g.shape[1:])
        g_disp_t = disps[0][scale]
        g_disp_s = [disps[s + 1][scale] for s in range(n_sources)]
        if loss_cfg.geo_res_cap > 0:
            while g_disp_t.shape[1] > loss_cfg.geo_res_cap:
                g_disp_t = _halve(g_disp_t)
                g_disp_s = [_halve(d) for d in g_disp_s]
        h_g, w_g = g_disp_t.shape[1], g_disp_t.shape[2]
        k_g = _scale_k(k, w_g / width, h_g / height)
        depth_g = depth_of(g_disp_t)
        src_depth_g = torch.cat([depth_of(d) for d in g_disp_s])
        x_g, y_g, z_g = project_depth(depth_g, k_g, torch.linalg.inv_ex(k_g).inverse, t_src)
        return x_g, y_g, z_g, src_depth_g, depth_g, h_g, w_g

    # Geo pass: every depth warp of the step in one sampler launch (and,
    # where a sampled source keeps its gradient, one scatter launch in the
    # backward). At one scale the per-source warps are shape-identical and
    # stack on the batch axis; the scales (and, under geo_grad="sym", the
    # reverse warps) are separate plane sets of the same launch. Sources
    # are detached where the reference stops their gradient, so T does not
    # run for them. Exact: both kernels act on each plane on its own.
    geo_grids: List[tuple] = []
    geo_sampled: List[Tuple[torch.Tensor, ...]] = []
    geo_reverse: List[List[torch.Tensor]] = []  # [scale][source] g_loss_r under "sym"
    sym = loss_cfg.geo_grad == "sym"
    if loss_cfg.geometric_weight > 0:
        geo_grids = [_geo_grid(scale) for scale in range(n_scales)]
        srcs, xs, ys = [], [], []
        for x_g, y_g, _, src_depth_g, _, _, _ in geo_grids:
            src = src_depth_g[:, None]
            srcs.append(src.detach() if sym or loss_cfg.geo_stopgrad else src)
            xs.append(x_g)
            ys.append(y_g)
        reverse = []
        if sym:
            # the reverse warp: the sources' points through the inverse
            # poses (each source's depth a grid of its own: S·B grids of
            # one transform each), sampling the (detached) target depth
            t_inv = torch.linalg.inv_ex(t_src).inverse.reshape(1, -1, 4, 4)
            for _, _, _, src_depth_g, depth_g, h_g, w_g in geo_grids:
                k_g = _scale_k(k, w_g / width, h_g / height)
                if k_g.ndim == 3:
                    k_g = k_g.repeat(n_sources, 1, 1)
                rev = project_depth(src_depth_g, k_g, torch.linalg.inv_ex(k_g).inverse, t_inv)
                reverse.append(rev)
                srcs.append(depth_g.detach().repeat(n_sources, 1, 1)[:, None])
                xs.append(rev[0])
                ys.append(rev[1])
        samp = bilinear_sample_full_multi(srcs, xs, ys)
        geo_sampled = [torch.chunk(sm[:, 0], n_sources) for sm in samp]
        for scale, (x_r, y_r, z_r) in enumerate(reverse):
            sampled_r = geo_sampled[n_scales + scale]
            geo_reverse.append([
                geometry_consistency(_of(z_r, s), sampled_r[s],
                                     _inside(_of(x_r, s), _of(y_r, s), *x_r.shape[1:]),
                                     behind=_of(z_r, s) <= 0, mesh=red)[0]
                for s in range(n_sources)])

    aux: Dict[str, torch.Tensor] = {}
    if (loss_cfg.scatter_audit and loss_cfg.geometric_weight > 0 and not sym
            and not loss_cfg.geo_stopgrad):
        # The reference counts the offset classes its TPU scatter would
        # drop; T drops none for any warp, so this is zero by construction.
        aux["geo/scatter_overflow"] = torch.zeros((), dtype=torch.float32, device=poses.device)

    photo_total = 0.0
    smooth_total = 0.0
    geo_total = 0.0
    for scale in range(n_scales):
        disp_s = disps[0][scale]

        warped_errors = []
        geo_losses = []
        for s in range(n_sources):
            x, y, z = (_of(t, s) for t in proj_all[scale])
            ph, pw = x.shape[1], x.shape[2]
            inside = _inside(x, y, ph, pw)
            valid = inside * (z > 0)
            err = err_lookup[(scale, s)] if loss_cfg.batched_photo else photometric_of(
                scale, s, x, y)
            if loss_cfg.geometric_weight > 0:
                x_g, y_g, z_g, _, _, h_g, w_g = geo_grids[scale]
                z_g = _of(z_g, s)
                gvalid = _inside(_of(x_g, s), _of(y_g, s), h_g, w_g)
                if loss_cfg.geo_full_res:
                    gvalid = gvalid * inside
                g_loss, g_weight = geometry_consistency(
                    z_g, geo_sampled[scale][s], gvalid, behind=z_g <= 0, mesh=red
                )
                if sym:
                    g_loss = 0.5 * (g_loss + geo_reverse[scale][s])
                if ph // h_g > 1:  # (1 under geo_full_res)
                    up = ph // h_g
                    g_weight = upsample_nearest(g_weight[..., None], up)[..., 0]
                    gvalid = upsample_nearest(gvalid[..., None], up)[..., 0]
                geo_losses.append(g_loss)
                # Downweight photometrically where geometry disagrees
                # (occlusion/dynamic) — the DCDP loss-level coupling. The
                # weights join in err's dtype (bf16 under compute_dtype).
                gw = g_weight.to(err.dtype)
                gv = (gvalid * valid).to(err.dtype)
                err = err * gw + err * (1.0 - gv)
            warped_errors.append(err)

        errors = torch.stack(warped_errors, dim=-1)  # (B, h, w, S)
        # reductions in float32 whatever the planes' dtype
        if loss_cfg.automask:
            min_err, mask = automask_fn(errors, _at(identity, scale))
            mask32 = mask.float()
            photo = red.sum(min_err.float() * mask32) / (red.sum(mask32) + 1e-7)
        elif loss_cfg.min_reprojection:
            photo = red.mean(torch.amin(errors, dim=-1).float())
        else:
            photo = red.mean(errors.float())

        tgt_small = tgt_clean[:, :: 2**scale, :: 2**scale]
        smooth = smoothness_loss(disp_s, tgt_small, red) / (2**scale)

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

    # Depth<->pose gauge hinge on r = mean||t|| / mean(depth): zero value
    # and gradient inside [gauge_lo, gauge_hi].
    if loss_cfg.gauge_weight > 0:
        t_mag = red.mean(torch.linalg.norm(poses[..., 3:].float(), dim=-1))
        d_mean = red.mean(full_depth.float())
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
