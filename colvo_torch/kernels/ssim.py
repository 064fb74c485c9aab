"""E: the photometric loss's SSIM+L1 error of a warped frame against its
target, and the warp's cotangent (``csrc/ssim.cu``): the function of
``window.photometric_error`` in one launch each way.

``ssim_error`` chooses by the tensor's device: a CUDA tensor takes kernel
E (``forward``: e in one launch, any error raised, other tensors refused;
under autograd ``backward`` gives the warp's cotangent in one more launch,
from the frames again: nothing but the inputs is saved), a CPU tensor the
plain ``window.photometric_error``. E differentiates by the warp alone:
on a card, a target that requires a gradient raises. Each launch counts as
``E/fwd/C<c>`` or ``E/bwd/C<c>`` (``kernels.launch_counts``).

The function, per pixel: the mean over channels of
α/2·(1 − SSIM3×3(ŵ, t)) + (1 − α)·|ŵ − t|, C1 = 0.01², C2 = 0.03², each
3×3 mean over the window's in-image pixels (SAME pooling).

Layout: (..., H, W, C) with any strides, float32 or bfloat16 (both
tensors one dtype), whose leading dims broadcast (the target may have
stride 0 over them); at most ``MAX_LEAD`` of size above 1 and 65,535
images. e comes out (..., H, W) contiguous; the warp's cotangent in its
layout where it has the broadcast shape (a permuted plane stack stays
one), else contiguous, summed to the warp's shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from colvo_torch.kernels import build
from colvo_torch.kernels.window import photometric_error

MAX_LEAD = 6  # kMaxLead of csrc/ssim.cu
MAX_IMAGES = 65535

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class SsimArgs(ctypes.Structure):
    """``SsimArgs`` of ``csrc/ssim.cu``, field for field."""
    _fields_ = [("w", _P), ("t", _P), ("g", _P), ("out", _P),
                ("w_hwc", _L * 3), ("t_hwc", _L * 3), ("o_hwc", _L * 3), ("g_hw", _L * 2),
                ("lead", _L * MAX_LEAD), ("w_lead", _L * MAX_LEAD), ("t_lead", _L * MAX_LEAD),
                ("o_lead", _L * MAX_LEAD), ("g_lead", _L * MAX_LEAD), ("n_lead", _I),
                ("h", _I), ("w_", _I), ("c", _I), ("alpha", _F)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/ssim.cu``'s entry
    points on a library built from it."""
    for fn in (lib.colvo_ssim_err_fwd, lib.colvo_ssim_err_bwd):
        if fn.argtypes is None:
            fn.argtypes = [SsimArgs, _L, _I, _P]
            fn.restype = _I
    if lib.colvo_ssim_smem_bytes.argtypes is None:
        lib.colvo_ssim_smem_bytes.argtypes = [_I, _I]
        lib.colvo_ssim_smem_bytes.restype = _L
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("ssim"))


def smem_bytes(c: int, backward: bool) -> int:
    """Dynamic shared memory a CTA of E's forward or backward takes at
    ``c`` channels, in bytes (from the built library)."""
    return _lib().colvo_ssim_smem_bytes(c, int(backward))


def backward_plain(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """Plain version of the backward: the cotangent of
    ``window.photometric_error`` at ``pred`` for ``g``, by autograd, the
    target a constant."""
    with torch.enable_grad():
        x = pred.detach().requires_grad_()
        (d,) = torch.autograd.grad(photometric_error(x, target.detach(), alpha), x, g)
    return d


def args(pred: torch.Tensor, target: torch.Tensor, out: torch.Tensor,
         g: Optional[torch.Tensor], alpha: float) -> SsimArgs:
    """The ``SsimArgs`` of one call at the broadcast shape of ``pred`` and
    ``target``: ``out`` is e (..., H, W) forward, or the cotangent of the
    broadcast warp (..., H, W, C) backward, with ``g`` the cotangent of e."""
    shape = torch.broadcast_shapes(pred.shape, target.shape)
    w, t = pred.expand(shape), target.expand(shape)
    o = out if out.dim() == len(shape) else out[..., None]
    lead = [d for d in range(len(shape) - 3) if shape[d] > 1]
    if len(lead) > MAX_LEAD:
        raise ValueError(f"ssim kernel takes at most {MAX_LEAD} leading dims above 1, got "
                         f"{tuple(shape)}")
    p = SsimArgs(w=w.data_ptr(), t=t.data_ptr(), out=out.data_ptr(), alpha=float(alpha))
    for name, x in (("w_hwc", w), ("t_hwc", t), ("o_hwc", o)):
        getattr(p, name)[:] = x.stride()[-3:]
    if g is not None:
        g = g.expand(shape[:-1])
        p.g = g.data_ptr()
        p.g_hw[:] = g.stride()[-2:]
    for i, d in enumerate(lead):
        p.lead[i] = shape[d]
        p.w_lead[i], p.t_lead[i], p.o_lead[i] = w.stride(d), t.stride(d), o.stride(d)
        p.g_lead[i] = g.stride(d) if g is not None else 0
    p.n_lead = len(lead)
    p.h, p.w_, p.c = shape[-3:]
    return p


def _check(pred: torch.Tensor, target: torch.Tensor, *rest: torch.Tensor) -> torch.Size:
    if pred.device.type != "cuda" or any(x.device != pred.device for x in (target, *rest)):
        raise ValueError(f"ssim kernel needs CUDA tensors on one device, got {pred.device} "
                         f"and {target.device}")
    if pred.dtype not in (torch.float32, torch.bfloat16) or any(
            x.dtype != pred.dtype for x in (target, *rest)):
        raise TypeError(f"ssim kernel takes float32 or bfloat16 frames of one dtype, got "
                        f"{pred.dtype} and {target.dtype}")
    shape = torch.broadcast_shapes(pred.shape, target.shape)
    if len(shape) < 3:
        raise ValueError(f"ssim kernel takes (..., H, W, C) frames, got {tuple(shape)}")
    if shape[:-3].numel() > MAX_IMAGES:
        raise ValueError(f"ssim kernel takes at most {MAX_IMAGES} images, got {tuple(shape)}")
    return shape


def _launch(name: str, p: SsimArgs, shape: torch.Size, pred: torch.Tensor) -> None:
    stream = torch.cuda.current_stream(pred.device).cuda_stream
    with torch.cuda.device(pred.device):
        err = getattr(_lib(), name)(p, shape[:-3].numel(), int(pred.dtype == torch.bfloat16),
                                    stream)
    if err != 0:
        raise ValueError(f"ssim kernel launch failed (cudaError {err}) at {tuple(shape)}: "
                         f"{shape[-1]} channels may not fit shared memory")


def forward(pred: torch.Tensor, target: torch.Tensor, alpha: float) -> torch.Tensor:
    """e (..., H, W): one launch of E's forward on CUDA tensors; other
    tensors raise."""
    shape = _check(pred, target)
    e = build.empty(shape[:-1].numel(), pred.dtype, pred.device).view(shape[:-1])
    _launch("colvo_ssim_err_fwd", args(pred, target, e, None, alpha), shape, pred)
    build.count_launch(f"E/fwd/C{shape[-1]}")
    return e


def backward(pred: torch.Tensor, target: torch.Tensor, g: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """The warp's cotangent for the cotangent ``g`` of e: one launch of E's
    backward on CUDA tensors, summed to ``pred``'s shape where it
    broadcast; other tensors raise."""
    shape = _check(pred, target, g)
    d = build.like(pred, shape)
    _launch("colvo_ssim_err_bwd", args(pred, target, d, g, alpha), shape, pred)
    build.count_launch(f"E/bwd/C{shape[-1]}")
    return d.sum_to_size(pred.shape)


class _SsimError(torch.autograd.Function):
    """Forward E, backward E's warp cotangent. Only the frames are saved:
    the backward recomputes the window moments."""

    @staticmethod
    def forward(ctx, pred, target, alpha):
        ctx.save_for_backward(pred, target)
        ctx.alpha = alpha
        return forward(pred, target, alpha)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        return backward(pred, target, g, ctx.alpha), None, None


def ssim_error(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.85) -> torch.Tensor:
    """``α·(1−SSIM)/2 + (1−α)·L1`` per pixel, mean over channels, of
    ``pred`` against ``target``, (..., H, W, C) each with leading dims
    broadcasting → (..., H, W): kernel E for CUDA tensors (float32 or
    bfloat16), ``window.photometric_error`` for CPU tensors. The target is
    data on a card: there, a target that requires a gradient raises."""
    if pred.device.type == "cpu":
        return photometric_error(pred, target, alpha)
    if build.needs_grad(target):
        raise ValueError("ssim_error takes the target as data on a card: it may not require "
                         "a gradient")
    if build.needs_grad(pred):
        return _SsimError.apply(pred, target, float(alpha))
    return forward(pred, target, alpha)
