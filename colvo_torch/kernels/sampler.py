"""S: bilinear sampling of C channel planes with optional d/dx, d/dy.

``sample`` is the kernel's wrapper: a CUDA tensor launches the CUDA kernel
(``csrc/sampler.cu``, which names the TPU kernels it replaces) and any
error raises; a CPU tensor takes ``sample_plain``, the plain PyTorch
gather beside it. ``launches`` counts kernel launches by variant.

Layout: src (N, C, H, W) f32 whose inner three dims are contiguous (the
batch stride is free, so a frame slice of a snippet stack needs no copy);
x, y (N, h, w) f32; outputs (N, C, h, w).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from colvo_torch.geometry.ops import bilinear_taps
from colvo_torch.kernels import build

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]

# Launches of the CUDA kernel, keyed "grad/C<c>" or "value/C<c>".
launches: Counter = Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.library("sampler")
    fn = lib.colvo_bilinear_sample
    if fn.argtypes is None:
        fn.argtypes = [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def sample_plain(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 with_grad: bool) -> Outputs:
    """Plain PyTorch version: four gathers (``geometry.ops.bilinear_sample``
    on planes) plus the analytic coordinate derivatives
    ∂out/∂x = (1−wy)(v01−v00) + wy(v11−v10) and ∂out/∂y = bot − top."""
    n, c, h, w = src.shape
    x0, x1, wx = bilinear_taps(x, w)
    y0, y1, wy = bilinear_taps(y, h)
    wx, wy = wx[:, None], wy[:, None]
    flat = src.reshape(n, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape(n, c, *x.shape[1:])

    v00, v01 = gather(y0, x0), gather(y0, x1)
    v10, v11 = gather(y1, x0), gather(y1, x1)
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    out = top + wy * (bot - top)
    if not with_grad:
        return out, None, None
    dt, db = v01 - v00, v11 - v10
    return out, dt + wy * (db - dt), bot - top


def _check(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"bilinear_sample kernel needs CUDA tensors, got {src.device}")
    if src.dtype != torch.float32 or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("bilinear_sample kernel takes float32 src and coords")
    if src.dim() != 4 or x.dim() != 3 or x.shape != y.shape or x.shape[0] != src.shape[0]:
        raise ValueError(f"bad shapes src {tuple(src.shape)} x {tuple(x.shape)} y {tuple(y.shape)}")
    n, c, h, w = src.shape
    # the stride of a size-1 dim is never stepped (and .contiguous() leaves it as is)
    if any(size > 1 and stride != want for size, stride, want in
           zip((c, h, w), src.stride()[1:], (h * w, w, 1))):
        raise ValueError("bilinear_sample kernel needs contiguous (C, H, W) planes")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("bilinear_sample kernel needs contiguous coords")
    if x.device != src.device or y.device != src.device:
        raise ValueError("src and coords must share one device")


def _sample_cuda(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 with_grad: bool) -> Outputs:
    _check(src, x, y)
    n, c, h, w = src.shape
    ho, wo = x.shape[1:]
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=src.device)
    dx = torch.empty_like(out) if with_grad else None
    dy = torch.empty_like(out) if with_grad else None
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = _lib().colvo_bilinear_sample(
            src.data_ptr(), src.stride(0), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), dx.data_ptr() if with_grad else None,
            dy.data_ptr() if with_grad else None,
            n, c, h, w, ho, wo, int(with_grad), stream,
        )
    if err != 0:
        raise RuntimeError(f"bilinear_sample kernel launch failed: cudaError {err}")
    launches[f"{'grad' if with_grad else 'value'}/C{c}"] += 1
    return out, dx, dy


def sample(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           with_grad: bool) -> Outputs:
    """Sample ``src`` at (x, y): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns (out, dx, dy); dx, dy are None
    without ``with_grad``."""
    if src.device.type == "cpu":
        return sample_plain(src, x, y, with_grad)
    return _sample_cuda(src, x, y, with_grad)
