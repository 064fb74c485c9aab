"""The photometric loss's windowed statistics in plain PyTorch (port of
``colvo/losses/photometric.py``'s): SAME-padded box sums and means over
the H, W dims of (..., H, W, C) tensors, SSIM and the SSIM+L1 error. They
are what kernels F and L compute by hand and are held to.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """SAME-padded 2-D box sum over the H, W dims of a (..., H, W, C) tensor."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    nchw = F.pad(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    out = F.avg_pool2d(nchw, window, 1, divisor_override=1).permute(0, 2, 3, 1)
    return out.reshape(x.shape)


def window_count(x: torch.Tensor, window: int) -> torch.Tensor:
    """Each window's pixels inside the image, (1, H, W, 1) in x's dtype."""
    ones = torch.ones((1,) + x.shape[-3:-1] + (1,), dtype=x.dtype, device=x.device)
    return box_sum(ones, window)


def avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Mean filter with SAME padding; border pixels divide by the true
    window overlap."""
    return box_sum(x, window) / window_count(x, window)


def ssim_moments(x: torch.Tensor, y: torch.Tensor, window: int = 3) -> Tuple[torch.Tensor, ...]:
    """SSIM's windowed moments: μx, μy, σx², σy², σxy."""
    mu_x = avg_pool_same(x, window)
    mu_y = avg_pool_same(y, window)
    sigma_x = avg_pool_same(x * x, window) - mu_x * mu_x
    sigma_y = avg_pool_same(y * y, window) - mu_y * mu_y
    sigma_xy = avg_pool_same(x * y, window) - mu_x * mu_y
    return mu_x, mu_y, sigma_x, sigma_y, sigma_xy


def ssim(x: torch.Tensor, y: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Per-pixel SSIM over local windows; (B, H, W, C) in [−1, 1]."""
    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y, sigma_x, sigma_y, sigma_xy = ssim_moments(x, y, window)
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
