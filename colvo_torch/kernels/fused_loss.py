"""F: fused warp + LCC + SSIM + L1 photometric error and its coordinate
cotangent (``csrc/fused_loss.cu``).

``fused_error`` (``loss.fused_kernel``'s error of one source frame) runs
forward P7 and backward P8; ``err`` and ``err_bwd`` choose by the
tensor's device: a CUDA tensor launches the kernel (the source names the
TPU kernels it replaces) and any error raises; a CPU tensor takes the
plain versions beside them. Each launch counts as ``F/fwd/C<c>`` or
``F/bwd/C<c>`` (``kernels.launch_counts``).

The function: w = bilinear sample of ``src`` at (x, y); with
``lcc_window`` > 0, ŵ = a·w + b, the windowed affine LCC of ``lcc``
(a and b constants to the gradient); per channel
e_c = α/2·(1 − SSIM(ŵ, t)) + (1 − α)·|ŵ − t|; e = mean of e_c over
channels. Gradients flow to x and y only: the frames are data.

Layout: src (N, C, Hs, Ws) and tgt (N, C, h, w) f32 whose inner three dims
are contiguous (batch strides are free, so frame slices of a snippet stack
need no copy); x, y (N, h, w) f32 contiguous; e, g, gx, gy (N, h, w).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from colvo_torch.kernels import build, lcc
from colvo_torch.kernels.sampler import planes_contiguous, sample_plain
from colvo_torch.kernels.window import box_sum, photometric_error, ssim_moments, window_count

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_loss")
    fwd, bwd = lib.colvo_fused_err_fwd, lib.colvo_fused_err_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [_P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
        fwd.restype = _I
        bwd.argtypes = [_P, _L, _P, _L, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _P]
        bwd.restype = _I
    return lib


def _nhwc(planes: torch.Tensor) -> torch.Tensor:
    return planes.permute(0, 2, 3, 1)


def err_plain(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              lcc_window: int, alpha: float) -> torch.Tensor:
    """Plain version of the forward: the composed sampler → LCC → SSIM+L1
    of the port's own plain functions (LCC's ``lcc.window_plain``, which
    launches no kernel on a card)."""
    warped = _nhwc(sample_plain(src, x, y, False)[0])
    tgt = _nhwc(tgt)
    if lcc_window:
        warped = lcc.window_plain(warped, tgt, lcc_window, (0.5, 2.0), "affine")
    return photometric_error(warped, tgt, alpha)


def err_bwd_plain(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  g: torch.Tensor, lcc_window: int, alpha: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the analytic transpose the kernel
    applies (``colvo/kernels/fused_loss.py:203-234``): with g̃ = −α/2·g/C
    and B3 the 3×3 box sum,
    dŵ = B3(g̃·G1/n3) + 2ŵ·B3(g̃·G2/n3) + t·B3(g̃·G3/n3) + (1−α)·g/C·sign(ŵ−t),
    dw = a·dŵ, and gx, gy = Σ_c dw·∂w/∂x, Σ_c dw·∂w/∂y."""
    w, dx, dy = (_nhwc(v) for v in sample_plain(src, x, y, True))
    t = _nhwc(tgt)
    a = None
    if lcc_window:
        a, b = lcc.coefficients(w, t, lcc_window, (0.5, 2.0), "affine")
        w = a * w + b
    c1, c2 = 0.01**2, 0.03**2
    n3 = window_count(w, 3)
    m_x, m_y, s_x, s_y, s_xy = ssim_moments(w, t)
    n1, n2 = 2 * m_x * m_y + c1, 2 * s_xy + c2
    d1, d2 = m_x * m_x + m_y * m_y + c1, s_x + s_y + c2
    ds_dmu = (2 * m_y * n2 * d1 - 2 * m_x * n1 * n2) / (d1 * d1 * d2)
    ds_dsx = -(n1 * n2) / (d1 * d2 * d2)
    ds_dsxy = 2 * n1 / (d1 * d2)
    g1 = ds_dmu - 2 * m_x * ds_dsx - m_y * ds_dsxy
    gc = (g / w.shape[-1])[..., None]
    gt = -(alpha * 0.5) * gc
    d_what = (box_sum(gt * g1 / n3, 3) + 2 * w * box_sum(gt * ds_dsx / n3, 3)
              + t * box_sum(gt * ds_dsxy / n3, 3) + (1.0 - alpha) * gc * torch.sign(w - t))
    dw = d_what if a is None else a * d_what
    return (dw * dx).sum(-1), (dw * dy).sum(-1)


def _check(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           *rest: torch.Tensor) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"fused_loss kernel needs CUDA tensors, got {src.device}")
    if any(t.dtype != torch.float32 for t in (src, tgt, x, y, *rest)):
        raise TypeError("fused_loss kernel takes float32 frames, coords and cotangent")
    n, c = src.shape[:2]
    if (src.dim() != 4 or x.dim() != 3 or x.shape[0] != n
            or tgt.shape != (n, c) + x.shape[1:]
            or any(t.shape != x.shape for t in (y, *rest))):
        raise ValueError(f"bad shapes src {tuple(src.shape)} tgt {tuple(tgt.shape)} "
                         f"x {tuple(x.shape)} y {tuple(y.shape)}")
    if not (planes_contiguous(src) and planes_contiguous(tgt)):
        raise ValueError("fused_loss kernel needs contiguous (C, H, W) frame planes")
    if not all(t.is_contiguous() for t in (x, y, *rest)):
        raise ValueError("fused_loss kernel needs contiguous coords and cotangent")
    if any(t.device != src.device for t in (tgt, x, y, *rest)):
        raise ValueError("frames, coords and cotangent must share one device")


def _call(name: str, src, tgt, x, y, *tensors, lcc_window: int, alpha: float) -> None:
    n, c, hs, ws = src.shape
    h, w = x.shape[1:]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = getattr(_lib(), name)(
            src.data_ptr(), src.stride(0), tgt.data_ptr(), tgt.stride(0),
            x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in tensors),
            n, c, hs, ws, h, w, lcc_window, alpha, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_loss kernel launch failed: cudaError {err}")


def err(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
        lcc_window: int, alpha: float) -> torch.Tensor:
    """Error map e (N, h, w): kernel P7 for a CUDA tensor, the plain version
    for a CPU tensor."""
    if src.device.type == "cpu":
        return err_plain(src, tgt, x, y, lcc_window, alpha)
    _check(src, tgt, x, y)
    out = torch.empty(x.shape, dtype=torch.float32, device=src.device)
    _call("colvo_fused_err_fwd", src, tgt, x, y, out, lcc_window=lcc_window, alpha=alpha)
    build.count_launch(f"F/fwd/C{src.shape[1]}")
    return out


def err_bwd(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            g: torch.Tensor, lcc_window: int, alpha: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangent g of e → (gx, gy): kernel P8 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if src.device.type == "cpu":
        return err_bwd_plain(src, tgt, x, y, g, lcc_window, alpha)
    _check(src, tgt, x, y, g)
    gx = torch.empty(x.shape, dtype=torch.float32, device=src.device)
    gy = torch.empty_like(gx)
    _call("colvo_fused_err_bwd", src, tgt, x, y, g, gx, gy, lcc_window=lcc_window,
          alpha=alpha)
    build.count_launch(f"F/bwd/C{src.shape[1]}")
    return gx, gy


class _FusedError(torch.autograd.Function):
    """Forward F (P7), backward F's coordinate cotangent (P8). Only the
    inputs are saved: the backward recomputes the warp and the window
    statistics instead of keeping them in memory."""

    @staticmethod
    def forward(ctx, src, tgt, x, y, lcc_window, alpha):
        ctx.save_for_backward(src, tgt, x, y)
        ctx.cfg = (lcc_window, alpha)
        return err(src, tgt, x, y, lcc_window, alpha)

    @staticmethod
    def backward(ctx, g):
        src, tgt, x, y = ctx.saved_tensors
        gx, gy = err_bwd(src, tgt, x, y, g.contiguous(), *ctx.cfg)
        return None, None, gx, gy, None, None


def fused_error(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                lcc_window: int, alpha: float) -> torch.Tensor:
    """Per-pixel photometric error (N, h, w) of ``src`` (N, C, H, W) warped
    to (x, y) against ``tgt`` (N, C, h, w), with the windowed affine LCC
    where ``lcc_window`` > 0; gradients flow to x and y only."""
    x, y = x.contiguous(), y.contiguous()
    if build.needs_grad(x, y):
        return _FusedError.apply(src, tgt, x, y, lcc_window, alpha)
    return err(src, tgt, x, y, lcc_window, alpha)
