"""Photometric loss + LCC calibration (port of ``colvo/losses/photometric.py``).

* ``ssim`` / ``photometric_error``: ``α·(1−SSIM)/2 + (1−α)·L1`` with 3×3
  SSIM windows, constants C1 = 0.01², C2 = 0.03².
* ``lcc_calibrate``: Light Consistent Calibration of the warped source to
  the target from windowed (and optionally per-frame global) statistics,
  with the coefficients clipped and stop-gradiented; see the JAX module for
  the rationale of each mode. Its windowed step (``affine``, ``gain``) is
  ``kernels.lcc_window``: kernel L on a card, the plain means on the CPU.

Images are (B, H, W, C) as in the JAX package, or (..., H, W, C) with any
leading dims that broadcast against each other (the batched photometric
stack compares each target with all its warps without copying it); any
strides work.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from colvo_torch.kernels import lcc_window


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """SAME-padded 2-D box sum over the H, W dims of a (..., H, W, C) tensor."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    nchw = F.pad(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    out = F.avg_pool2d(nchw, window, 1, divisor_override=1).permute(0, 2, 3, 1)
    return out.reshape(x.shape)


def _avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean filter with SAME padding; border pixels divide by the true
    window overlap."""
    ones = torch.ones((1,) + x.shape[-3:-1] + (1,), dtype=x.dtype, device=x.device)
    return _box_sum(x, window) / _box_sum(ones, window)


def ssim(x: torch.Tensor, y: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Per-pixel SSIM over local windows; (B, H, W, C) in [−1, 1]."""
    c1, c2 = 0.01**2, 0.03**2
    mu_x = _avg_pool_same(x, window)
    mu_y = _avg_pool_same(y, window)
    sigma_x = _avg_pool_same(x * x, window) - mu_x * mu_x
    sigma_y = _avg_pool_same(y * y, window) - mu_y * mu_y
    sigma_xy = _avg_pool_same(x * y, window) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return num / den


def photometric_error(
    pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.85
) -> torch.Tensor:
    """``α·(1−SSIM)/2 + (1−α)·L1`` per pixel, mean over channels → (B, H, W)."""
    l1 = torch.mean(torch.abs(pred - target), dim=-1)
    if alpha == 0.0:
        return l1
    s = torch.mean(ssim(pred, target), dim=-1)
    return alpha * 0.5 * (1.0 - s) + (1.0 - alpha) * l1


def lcc_calibrate(
    warped: torch.Tensor,
    target: torch.Tensor,
    mode: str = "affine",
    window: int = 15,
    clip: Tuple[float, float] = (0.5, 2.0),
    valid_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Recalibrate the warped frame's luminance to the target.

    Modes: ``off``; ``gain`` (ŵ = g·w, g = μ_t/μ_w); ``affine`` (ŵ = a·w + b,
    a = cov(w,t)/var(w)); ``global`` (one affine per frame and channel,
    clipped to (0.25, 4)); ``global+affine`` and ``global+gain`` (the
    global affine, then the windowed mode). Windowed coefficients are
    clipped to ``clip``; all coefficients are stop-gradiented. With
    ``valid_mask`` the global moments are means over valid pixels only.
    """
    if mode == "off":
        return warped
    if mode.startswith("global"):
        if valid_mask is not None:
            m = valid_mask.to(warped.dtype)
            if m.ndim == warped.ndim - 1:
                m = m[..., None]
            m = m.detach()
            denom = torch.sum(m, dim=(-3, -2), keepdim=True) + 1e-6

            def _gmean(x):
                return torch.sum(x * m, dim=(-3, -2), keepdim=True) / denom
        else:
            def _gmean(x):
                return torch.mean(x, dim=(-3, -2), keepdim=True)

        gmu_w = _gmean(warped)
        gmu_t = _gmean(target)
        gvar = _gmean(warped * warped) - gmu_w**2
        gcov = _gmean(warped * target) - gmu_w * gmu_t
        ga = torch.clamp(gcov / (gvar + 1e-7), 0.25, 4.0)
        gb = gmu_t - ga * gmu_w
        warped = ga.detach() * warped + gb.detach()
        rest = mode[len("global"):].lstrip("+")
        if not rest:
            return warped
        mode = rest
    return lcc_window(warped, target, window, clip, mode)
