"""L: LCC's windowed calibration of a warped frame to its target
(``csrc/lcc.cu``), the windowed step of ``losses.photometric.lcc_calibrate``.

``lcc_window`` chooses by the tensor's device: a CUDA tensor takes kernel
L (``forward``: one launch, any error raised, other tensors refused; with
autograd it also writes a, and the warp's cotangent is g·a), a CPU tensor
``window_plain``, the plain version: the composed ``window.avg_pool_same``
means. Each launch counts as ``L/affine`` or ``L/gain``
(``kernels.launch_counts``).

The function, with means over the window's in-image overlap (SAME
padding): ``affine``, ŵ = a·w + b with a = clamp(cov(w,t)/(var(w) + 1e-4),
clip) and b = μt − a·μw; ``gain``, ŵ = a·w with a = clamp(μt/(μw + 1e-4),
clip). a and b are constants to the gradient, so the warp's cotangent is
g·a and the target gets none.

Layout: (..., H, W, C) with any strides, float32 or bfloat16 (both
tensors one dtype), whose leading dims broadcast (the target may have
stride 0 over them); at most ``MAX_LEAD`` of size above 1 and 65,535
images. ŵ and a come out in the warp's layout where it has the broadcast
shape (a permuted plane stack stays one), else contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from colvo_torch.kernels import build
from colvo_torch.kernels.window import avg_pool_same

MAX_LEAD = 6  # kMaxLead of csrc/lcc.cu
MAX_IMAGES = 65535
MODES = ("affine", "gain")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class LccArgs(ctypes.Structure):
    """``LccArgs`` of ``csrc/lcc.cu``, field for field."""
    _fields_ = [("w", _P), ("t", _P), ("out", _P), ("a", _P),
                ("w_hwc", _L * 3), ("t_hwc", _L * 3), ("o_hwc", _L * 3),
                ("lead", _L * MAX_LEAD), ("w_lead", _L * MAX_LEAD), ("t_lead", _L * MAX_LEAD),
                ("o_lead", _L * MAX_LEAD), ("n_lead", _I), ("h", _I), ("w_", _I), ("c", _I),
                ("lo", _I), ("hi", _I), ("gain", _I), ("clip_lo", _F), ("clip_hi", _F),
                ("tw", _I), ("rows", _I)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/lcc.cu``'s entry point
    on a library built from it."""
    fn = lib.colvo_lcc_window
    if fn.argtypes is None:
        fn.argtypes = [LccArgs, _L, _I, _P]
        fn.restype = _I
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("lcc"))


def coefficients(warped: torch.Tensor, target: torch.Tensor, window: int,
                 clip: Sequence[float], mode: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(a, b) of the plain version, b None under ``gain``: the windowed means
    by ``window.avg_pool_same``."""
    eps = 1e-4
    mu_w = avg_pool_same(warped, window)
    mu_t = avg_pool_same(target, window)
    if mode == "gain":
        return torch.clamp(mu_t / (mu_w + eps), clip[0], clip[1]), None
    if mode == "affine":
        var_w = avg_pool_same(warped * warped, window) - mu_w * mu_w
        cov = avg_pool_same(warped * target, window) - mu_w * mu_t
        a = torch.clamp(cov / (var_w + eps), clip[0], clip[1])
        return a, mu_t - a * mu_w
    raise ValueError(f"unknown lcc mode {mode!r}")


def window_plain(warped: torch.Tensor, target: torch.Tensor, window: int,
                 clip: Sequence[float], mode: str) -> torch.Tensor:
    """Plain version: ŵ from ``coefficients``, stop-gradiented."""
    a, b = coefficients(warped, target, window, clip, mode)
    if b is None:
        return a.detach() * warped
    return a.detach() * warped + b.detach()


def args(warped: torch.Tensor, target: torch.Tensor, out: torch.Tensor,
         a: Optional[torch.Tensor], window: int, clip: Sequence[float], mode: str) -> LccArgs:
    """The ``LccArgs`` of one call writing ŵ to ``out`` (and a to ``a``,
    which has out's strides, unless None), at out's shape."""
    shape = out.shape
    w, t = warped.expand(shape), target.expand(shape)
    lead = [d for d in range(len(shape) - 3) if shape[d] > 1]
    if len(lead) > MAX_LEAD:
        raise ValueError(f"lcc kernel takes at most {MAX_LEAD} leading dims above 1, got "
                         f"{tuple(shape)}")
    if a is not None and a.stride() != out.stride():
        raise ValueError("lcc kernel writes a in out's layout")
    for x in (w, t):  # the kernel's loads take in-image offsets in 32 bits
        if sum((n - 1) * abs(st) for n, st in zip(shape[-3:], x.stride()[-3:])) >= 2**31:
            raise ValueError(f"lcc kernel takes frames whose in-image offsets fit 32 bits, got "
                             f"strides {x.stride()}")
    p = LccArgs(w=w.data_ptr(), t=t.data_ptr(), out=out.data_ptr(),
                a=a.data_ptr() if a is not None else None)
    for name, x in (("w_hwc", w), ("t_hwc", t), ("o_hwc", out)):
        getattr(p, name)[:] = x.stride()[-3:]
    for i, d in enumerate(lead):
        p.lead[i] = shape[d]
        p.w_lead[i], p.t_lead[i], p.o_lead[i] = w.stride(d), t.stride(d), out.stride(d)
    p.n_lead = len(lead)
    p.h, p.w_, p.c = shape[-3:]
    p.lo = (window - 1) // 2
    p.hi = window - 1 - p.lo
    p.gain = int(mode == "gain")
    p.clip_lo, p.clip_hi = float(clip[0]), float(clip[1])
    return p


def _check(warped: torch.Tensor, target: torch.Tensor, window: int, mode: str) -> torch.Size:
    if warped.device.type != "cuda" or target.device != warped.device:
        raise ValueError(f"lcc kernel needs CUDA tensors on one device, got {warped.device} "
                         f"and {target.device}")
    if warped.dtype not in (torch.float32, torch.bfloat16) or target.dtype != warped.dtype:
        raise TypeError(f"lcc kernel takes float32 or bfloat16 frames of one dtype, got "
                        f"{warped.dtype} and {target.dtype}")
    if mode not in MODES:
        raise ValueError(f"unknown lcc mode {mode!r}")
    if int(window) != window or window < 1:
        raise ValueError(f"lcc window must be a positive int, got {window!r}")
    shape = torch.broadcast_shapes(warped.shape, target.shape)
    if len(shape) < 3:
        raise ValueError(f"lcc kernel takes (..., H, W, C) frames, got {tuple(shape)}")
    if shape[:-3].numel() > MAX_IMAGES:
        raise ValueError(f"lcc kernel takes at most {MAX_IMAGES} images, got {tuple(shape)}")
    return shape


def forward(warped: torch.Tensor, target: torch.Tensor, window: int, clip: Sequence[float],
            mode: str, with_a: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(ŵ, a): one launch of L on CUDA tensors (a is None unless
    ``with_a``). Other tensors, and a window that cannot fit shared
    memory, raise."""
    shape = _check(warped, target, window, mode)
    out = build.like(warped, shape)
    a = build.like(warped, shape) if with_a else None
    p = args(warped, target, out, a, window, clip, mode)
    stream = torch.cuda.current_stream(warped.device).cuda_stream
    with torch.cuda.device(warped.device):
        err = _lib().colvo_lcc_window(p, shape[:-3].numel(), int(warped.dtype == torch.bfloat16),
                                      stream)
    if err != 0:
        raise ValueError(f"lcc kernel launch failed (cudaError {err}): window {window} at "
                         f"{tuple(shape)} may not fit shared memory")
    build.count_launch(f"L/{mode}")
    return out, a


class _LccWindow(torch.autograd.Function):
    """Forward L with a; backward g·a, summed to the warp's shape where it
    broadcast. The target is data."""

    @staticmethod
    def forward(ctx, warped, target, window, clip, mode):
        out, a = forward(warped, target, window, clip, mode, with_a=True)
        ctx.save_for_backward(a)
        ctx.shape = warped.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return (g * a).sum_to_size(ctx.shape), None, None, None, None


def lcc_window(warped: torch.Tensor, target: torch.Tensor, window: int = 15,
               clip: Tuple[float, float] = (0.5, 2.0), mode: str = "affine") -> torch.Tensor:
    """LCC's windowed calibration of ``warped`` to ``target``, (..., H, W, C)
    each, leading dims broadcasting: kernel L for CUDA tensors (float32 or
    bfloat16), ``window_plain`` for CPU tensors. Gradients flow to
    ``warped`` only, as g·a."""
    if warped.device.type == "cpu":
        return window_plain(warped, target, window, clip, mode)
    if build.needs_grad(warped):
        return _LccWindow.apply(warped, target, window, tuple(clip), mode)
    return forward(warped, target, window, clip, mode, with_a=False)[0]
