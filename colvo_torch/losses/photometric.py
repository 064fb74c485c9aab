"""Photometric loss + LCC calibration (port of ``colvo/losses/photometric.py``).

* ``ssim`` / ``photometric_error``: ``α·(1−SSIM)/2 + (1−α)·L1`` with 3×3
  SSIM windows, constants C1 = 0.01², C2 = 0.03² (``kernels/window.py``).
  ``photometric_error`` is ``kernels.ssim_error``: kernel E on a card, the
  plain ``window.photometric_error`` on the CPU.
* ``lcc_calibrate``: Light Consistent Calibration of the warped source to
  the target from windowed (and optionally per-frame global) statistics,
  with the coefficients clipped and stop-gradiented; see the JAX module for
  the rationale of each mode. Its windowed step (``affine``, ``gain``) is
  ``kernels.lcc_window``: kernel L on a card, the plain means on the CPU.
* ``warp_photometric``: ``loss.fused_kernel``'s error of one source frame.

Images are (B, H, W, C) as in the JAX package, or (..., H, W, C) with any
leading dims that broadcast against each other (the batched photometric
stack compares each target with all its warps without copying it); any
strides work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from colvo_torch.kernels import bilinear_sample_planes, fused_error, lcc_window
from colvo_torch.kernels import ssim_error as photometric_error
from colvo_torch.kernels.window import ssim

__all__ = ["ssim", "photometric_error", "lcc_calibrate", "warp_photometric"]


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


def warp_photometric(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, lcc_mode: str, lcc_window: int,
                     alpha: float) -> torch.Tensor:
    """Per-pixel photometric error (N, h, w) of ``src`` (N, C, H, W) warped
    to (x, y) against ``tgt`` (N, C, h, w); gradients flow to x and y only.
    Mirrors ``colvo.kernels.warp_photometric_fast``: kernel F
    (``kernels.fused_error``) where LCC is affine or off and α > 0, else the
    composed sampler → ``lcc_calibrate`` → ``photometric_error``, whose LCC
    pools no valid mask."""
    if lcc_mode in ("affine", "off") and alpha > 0.0:
        return fused_error(src, tgt, x, y, lcc_window if lcc_mode == "affine" else 0, alpha)
    warped = bilinear_sample_planes(src, x, y).permute(0, 2, 3, 1)
    tgt = tgt.permute(0, 2, 3, 1)
    if lcc_mode != "off":
        warped = lcc_calibrate(warped, tgt, lcc_mode, lcc_window)
    return photometric_error(warped, tgt, alpha)
