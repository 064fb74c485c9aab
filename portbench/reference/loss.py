"""ColVO's self-supervised snippet loss, plain and float32.

The default DCDP+LCC objective: per scale and source, the disparity
upsampled to full resolution, backprojection, the target→source warp by
bilinear sampling with border clamp, windowed affine LCC (coefficients
clipped to [0.5, 2] and held constant in the backward), SSIM (3×3) and L1
mixed by α, automasking against the unwarped sources, edge-aware
smoothness, the geometric term on each scale's own grid (projected depth
against the sampled source depth, with the behind-camera penalty) and the
depth↔pose gauge hinge. Gradients come from autograd through the gathers,
which is the sampler's analytic derivative and its transposed scatter.
Knobs that change this function are refused.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

_INT32_WRAP = 2147483648.0


def check_supported(loss_cfg) -> None:
    same = dict(lcc=True, lcc_mode="affine", lcc_identity=False, photo_native=False,
                geo_full_res=False, geo_res_cap=0, geo_grad="both", geo_stopgrad=False,
                automask=True, compute_dtype="")
    for key, want in same.items():
        if getattr(loss_cfg, key) != want and not (key == "compute_dtype"
                                                     and loss_cfg.compute_dtype == "float32"):
            raise NotImplementedError(f"the reference loss has no loss.{key}="
                                      f"{getattr(loss_cfg, key)!r}")


def disp_to_depth(disp, min_depth, max_depth):
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (lo + (hi - lo) * disp)


def backproject(depth, k_inv):
    _, h, w = depth.shape
    y, x = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                          torch.arange(w, dtype=depth.dtype, device=depth.device),
                          indexing="ij")
    grid = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return depth[..., None] * torch.einsum("ij,hwj->hwi", k_inv, grid)[None]


def project(points, k, t_mat):
    cam = torch.einsum("bij,bhwj->bhwi", t_mat[:, :3, :3], points) + t_mat[:, None, None, :3, 3]
    uvw = torch.einsum("ij,bhwj->bhwi", k, cam)
    z = uvw[..., 2]
    return uvw[..., :2] / (z[..., None] + 1e-7), z


def taps(coord, size):
    f = torch.floor(coord)
    i = torch.clamp(f, -1.0, float(size)).to(torch.int64)
    i0 = torch.clamp(i, 0, size - 1)
    i1 = torch.where(f >= _INT32_WRAP, 0, torch.clamp(i + 1, 0, size - 1))
    return i0, i1, coord - f


def sample(img, pix):
    """Bilinear sampling with border clamp: img (B, H, W, C), pix (B, h, w, 2)
    as (x, y) → (B, h, w, C)."""
    b, h, w, c = img.shape
    x0, x1, wx = taps(pix[..., 0], w)
    y0, y1, wy = taps(pix[..., 1], h)
    wx, wy = wx[..., None], wy[..., None]
    flat = img.reshape(b, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(pix.shape[:-1] + (c,))

    top = at(y0, x0) + wx * (at(y0, x1) - at(y0, x0))
    bot = at(y1, x0) + wx * (at(y1, x1) - at(y1, x0))
    return top + wy * (bot - top)


def valid_mask(pix, h, w):
    eps = 1e-3
    x, y = pix[..., 0], pix[..., 1]
    return ((x >= -eps) & (x <= w - 1 + eps) & (y >= -eps) & (y <= h - 1 + eps)).to(pix.dtype)


def rotation(aa):
    """Rodrigues with the Taylor branch below θ² = 1e-8."""
    tsq = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    small = tsq < 1e-8
    safe = torch.where(small, torch.ones_like(tsq), tsq)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - tsq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - tsq / 24.0, (1.0 - torch.cos(th)) / safe)
    wx, wy, wz = aa[..., 0], aa[..., 1], aa[..., 2]
    z = torch.zeros_like(wx)
    k = torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                     torch.stack([-wy, wx, z], -1)], dim=-2)
    return torch.eye(3, dtype=aa.dtype, device=aa.device) + a * k + b * (k @ k)


def transforms(poses):
    """(B, S, 6) → (B, S, 4, 4) ``[R(aa) | t]``."""
    top = torch.cat([rotation(poses[..., :3]), poses[..., 3:, None]], dim=-1)
    bottom = torch.zeros(poses.shape[:-1] + (1, 4), dtype=poses.dtype, device=poses.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _box_mean(x, window):
    """SAME mean filter over H, W of (B, H, W, C); borders divide by the overlap."""
    lo, hi = (window - 1) // 2, window - 1 - (window - 1) // 2

    def box(t):
        n = F.pad(t.permute(0, 3, 1, 2), (lo, hi, lo, hi))
        return F.avg_pool2d(n, window, 1, divisor_override=1).permute(0, 2, 3, 1)

    ones = torch.ones((1,) + x.shape[1:3] + (1,), dtype=x.dtype, device=x.device)
    return box(x) / box(ones)


def ssim(x, y):
    c1, c2 = 0.01**2, 0.03**2
    mx, my = _box_mean(x, 3), _box_mean(y, 3)
    sx = _box_mean(x * x, 3) - mx * mx
    sy = _box_mean(y * y, 3) - my * my
    sxy = _box_mean(x * y, 3) - mx * my
    return ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sx + sy + c2))


def photometric_error(pred, target, alpha):
    l1 = torch.mean(torch.abs(pred - target), dim=-1)
    s = torch.mean(ssim(pred, target), dim=-1)
    return alpha * 0.5 * (1.0 - s) + (1.0 - alpha) * l1


def lcc_affine(warped, target, window, clip=(0.5, 2.0)):
    mu_w, mu_t = _box_mean(warped, window), _box_mean(target, window)
    var_w = _box_mean(warped * warped, window) - mu_w * mu_w
    cov = _box_mean(warped * target, window) - mu_w * mu_t
    a = torch.clamp(cov / (var_w + 1e-4), clip[0], clip[1])
    b = mu_t - a * mu_w
    return a.detach() * warped + b.detach()


def geometry_consistency(computed, sampled, valid, behind):
    raw = computed
    computed = torch.where(behind, sampled, computed)
    diff = torch.clamp(torch.abs(computed - sampled) / (computed + sampled + 1e-7), 0.0, 1.0)
    pen = torch.clamp(1.0 - raw / (torch.abs(sampled) + 1e-7), max=10.0)
    bfrac = torch.mean(behind.to(diff.dtype), dim=tuple(range(1, behind.ndim)), keepdim=True)
    pen = torch.where(bfrac > 0.05, pen, torch.ones_like(pen))
    diff = torch.where(behind, pen, diff)
    valid = torch.maximum(valid, behind.to(diff.dtype))
    diff = diff * valid
    loss = torch.sum(diff) / (torch.sum(valid) + 1e-7)
    return loss, torch.clamp(1.0 - diff, 0.0, 1.0) * valid


def smoothness(disp, img):
    nd = disp / (torch.mean(disp, dim=(1, 2), keepdim=True) + 1e-7)
    gx = torch.abs(nd[:, :, 1:] - nd[:, :, :-1])
    gy = torch.abs(nd[:, 1:] - nd[:, :-1])
    ix = torch.mean(torch.abs(img[:, :, 1:] - img[:, :, :-1]), dim=-1, keepdim=True)
    iy = torch.mean(torch.abs(img[:, 1:] - img[:, :-1]), dim=-1, keepdim=True)
    return torch.mean(gx * torch.exp(-ix)) + torch.mean(gy * torch.exp(-iy))


def _up(x, factor):
    return x if factor == 1 else x.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


def _scale_k(k, sx, sy):
    return torch.stack([k[0] * sx, k[1] * sy, k[2]])


def snippet_loss(disps: List[Dict[int, torch.Tensor]], poses, frames_clean, k, loss_cfg,
                 model_cfg) -> Dict[str, torch.Tensor]:
    """The loss terms of one snippet batch: {"loss/total", "loss/photometric",
    "loss/smoothness", "loss/geometric", "loss/gauge"}."""
    check_supported(loss_cfg)
    _, n, h, w, _ = frames_clean.shape
    n_src, n_scales = n - 1, model_cfg.n_scales
    lo_d, hi_d = model_cfg.min_depth, model_cfg.max_depth
    tgt = frames_clean[:, 0]
    t_mats = transforms(poses)
    k_inv = torch.linalg.inv(k)
    alpha = loss_cfg.ssim_alpha
    identity = torch.stack([photometric_error(frames_clean[:, s + 1], tgt, alpha)
                            for s in range(n_src)], dim=-1)
    photo_t = smooth_t = geo_t = 0.0
    full_depth = None
    for sc in range(n_scales):
        disp_s = disps[0][sc]
        depth = disp_to_depth(_up(disp_s, h // disp_s.shape[1])[..., 0], lo_d, hi_d)
        if sc == 0:
            full_depth = depth
        points = backproject(depth, k_inv)
        hg, wg = disp_s.shape[1], disp_s.shape[2]
        k_g = _scale_k(k, wg / w, hg / h)
        pts_g = backproject(disp_to_depth(disp_s[..., 0], lo_d, hi_d), torch.linalg.inv(k_g))
        errors, geo = [], []
        for s in range(n_src):
            pix, z = project(points, k, t_mats[:, s])
            valid = valid_mask(pix, h, w) * (z > 0)
            warped = sample(frames_clean[:, s + 1], pix)
            err = photometric_error(lcc_affine(warped, tgt, loss_cfg.lcc_window), tgt, alpha)
            if loss_cfg.geometric_weight > 0:
                pix_g, z_g = project(pts_g, k_g, t_mats[:, s])
                src_depth = disp_to_depth(disps[s + 1][sc], lo_d, hi_d)
                sampled = sample(src_depth, pix_g)[..., 0]
                gvalid = valid_mask(pix_g, hg, wg)
                g_loss, g_w = geometry_consistency(z_g, sampled, gvalid, z_g <= 0)
                up = h // hg
                g_w, gvalid = _up(g_w[..., None], up)[..., 0], _up(gvalid[..., None], up)[..., 0]
                geo.append(g_loss)
                err = err * g_w + err * (1.0 - gvalid * valid)
            errors.append(err)
        errors = torch.stack(errors, dim=-1)
        min_err = torch.amin(errors, dim=-1)
        mask = (min_err < torch.amin(identity, dim=-1) + 1e-5).float()
        photo_t = photo_t + torch.sum(min_err * mask) / (torch.sum(mask) + 1e-7)
        smooth_t = smooth_t + smoothness(disp_s, tgt[:, ::2**sc, ::2**sc]) / 2**sc
        if geo:
            geo_t = geo_t + sum(geo) / len(geo)
    photo_t, smooth_t = photo_t / n_scales, smooth_t / n_scales
    geo_t = geo_t / n_scales if loss_cfg.geometric_weight > 0 else torch.zeros_like(photo_t)
    total = photo_t + loss_cfg.smoothness_weight * smooth_t + loss_cfg.geometric_weight * geo_t
    out = {"loss/photometric": photo_t, "loss/smoothness": smooth_t, "loss/geometric": geo_t}
    if loss_cfg.gauge_weight > 0:
        t_mag = torch.mean(torch.linalg.norm(poses[..., 3:], dim=-1))
        log_r = torch.log(t_mag + 1e-12) - torch.log(torch.mean(full_depth) + 1e-12)
        gauge = (torch.clamp(math.log(loss_cfg.gauge_lo) - log_r, min=0.0) ** 2
                 + torch.clamp(log_r - math.log(loss_cfg.gauge_hi), min=0.0) ** 2)
        total = total + loss_cfg.gauge_weight * gauge
        out["loss/gauge"] = gauge
    out["loss/total"] = total
    return out
