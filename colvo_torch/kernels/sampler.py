"""S: bilinear sampling of C channel planes with optional d/dx, d/dy.

``bilinear_sample_planes`` (NHWC: ``bilinear_sample_fast``) and
``bilinear_sample_grouped_planes`` are the photometric warps' samplers:
forward S with d/dx, d/dy, backward the channel sums Σ_c g·dx, Σ_c g·dy;
no gradient to the image; S's value-only variant outside autograd.
``sample`` and ``sample_multi`` choose by the tensor's device: a CUDA
tensor launches a CUDA kernel (``csrc/sampler.cu``, which names the TPU
kernels it replaces) and any error raises; a CPU tensor takes
``sample_plain`` / ``sample_multi_plain``, the plain gathers beside them.
``sample_multi`` samples several plane sets (the geo scales of a step) in
one launch of the multi-plane-set kernel, which also takes every C=1 call
of ``sample``; C>1 and grouped calls launch ``bilinear_sample_kernel``.
Each launch counts as ``S/<variant>`` (``kernels.launch_counts``).

Layout: src (N, C, H, W) f32 whose inner three dims are contiguous (the
batch stride is free, so a frame slice of a snippet stack needs no copy);
x, y (N·group, h, w) f32; outputs (N·group, C, h, w). With ``group`` > 1
(the grouped sampler, P6) output plane ``i`` samples source frame
``i // group``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from colvo_torch.geometry.ops import bilinear_taps
from colvo_torch.kernels import build

Outputs = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# Descriptors one launch of the multi-plane-set kernel takes (kMaxDescs).
MAX_DESCS = 8


class SampleDesc(ctypes.Structure):
    """``SampleDesc`` of ``csrc/sampler.cu``, field for field."""
    _fields_ = [("src", _P), ("x", _P), ("y", _P), ("out", _P), ("dx", _P), ("dy", _P),
                ("src_bstride", _L), ("n", _I), ("c", _I), ("h_src", _I), ("w_src", _I),
                ("h_out", _I), ("w_out", _I), ("vec", _I), ("block0", _I)]


class GeoParams(ctypes.Structure):
    """``GeoParams`` of ``csrc/sampler.cu``, passed by value."""
    _fields_ = [("d", SampleDesc * MAX_DESCS), ("n_desc", _I), ("with_grad", _I)]


def _lib() -> ctypes.CDLL:
    lib = build.library("sampler")
    fn = lib.colvo_bilinear_sample
    if fn.argtypes is None:
        fn.argtypes = [_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        lib.colvo_bilinear_sample_multi.argtypes = [GeoParams, _P]
        lib.colvo_bilinear_sample_multi.restype = _I
    return lib


def sample_plain(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 with_grad: bool, group: int = 1) -> Outputs:
    """Plain PyTorch version: four gathers (``geometry.ops.bilinear_sample``
    on planes) plus the analytic coordinate derivatives
    ∂out/∂x = (1−wy)(v01−v00) + wy(v11−v10) and ∂out/∂y = bot − top.
    A grouped call samples the source repeated ``group`` times along the
    batch, as the reference's fallback does."""
    if group > 1:
        src = src.repeat_interleave(group, 0)
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


def sample_multi_plain(srcs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                       ys: Sequence[torch.Tensor], with_grad: bool) -> List[Outputs]:
    """Plain version of ``sample_multi``: ``sample_plain`` per plane set."""
    return [sample_plain(s, x, y, with_grad) for s, x, y in zip(srcs, xs, ys)]


def planes_contiguous(t: torch.Tensor) -> bool:
    """Whether the inner (C, H, W) dims of an (N, C, H, W) tensor are
    contiguous (the batch stride is free); the stride of a size-1 dim is
    never stepped (and ``.contiguous()`` leaves it as is)."""
    return all(size == 1 or stride == want for size, stride, want in
               zip(t.shape[1:], t.stride()[1:], (t.shape[2] * t.shape[3], t.shape[3], 1)))


def _check(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor, group: int) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"bilinear_sample kernel needs CUDA tensors, got {src.device}")
    if src.dtype != torch.float32 or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError("bilinear_sample kernel takes float32 src and coords")
    if (src.dim() != 4 or x.dim() != 3 or x.shape != y.shape or group < 1
            or x.shape[0] != src.shape[0] * group):
        raise ValueError(f"bad shapes src {tuple(src.shape)} x {tuple(x.shape)} "
                         f"y {tuple(y.shape)} group {group}")
    if not planes_contiguous(src):
        raise ValueError("bilinear_sample kernel needs contiguous (C, H, W) planes")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("bilinear_sample kernel needs contiguous coords")
    if x.device != src.device or y.device != src.device:
        raise ValueError("src and coords must share one device")


def _sample_multi_cuda(srcs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                       ys: Sequence[torch.Tensor], with_grad: bool) -> List[Outputs]:
    if not len(srcs) == len(xs) == len(ys):
        raise ValueError("sample_multi takes one x and one y plane stack per source")
    for src, x, y in zip(srcs, xs, ys):
        _check(src, x, y, 1)
    device, c = srcs[0].device, srcs[0].shape[1]
    if any(s.device != device for s in srcs) or any(s.shape[1] != c for s in srcs):
        raise ValueError("sample_multi takes plane sets of one device and one channel count")
    results: List[Outputs] = []
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in range(0, len(srcs), MAX_DESCS):
        params, outs = multi_params(srcs[lo:lo + MAX_DESCS], xs[lo:lo + MAX_DESCS],
                                    ys[lo:lo + MAX_DESCS], with_grad)
        with torch.cuda.device(device):
            err = _lib().colvo_bilinear_sample_multi(params, stream)
        if err != 0:
            raise RuntimeError(f"bilinear_sample_multi kernel launch failed: cudaError {err}")
        build.count_launch(f"S/{'grad' if with_grad else 'value'}/C{c}")
        results += outs
    return results


def multi_params(srcs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                 ys: Sequence[torch.Tensor], with_grad: bool) -> Tuple[GeoParams, List[Outputs]]:
    """The descriptor table of one launch of the multi-plane-set kernel for
    up to ``MAX_DESCS`` checked plane sets of one channel count, and its
    outputs (one allocation a plane set). A descriptor takes four pixels a
    thread where w_out % 4 == 0 and its coordinate and output pointers are
    16-byte aligned."""
    c, device = srcs[0].shape[1], srcs[0].device
    params = GeoParams(n_desc=len(srcs), with_grad=int(with_grad))
    results: List[Outputs] = []
    for i, (src, x, y) in enumerate(zip(srcs, xs, ys)):
        n, ho, wo = x.shape
        outs = torch.empty((3 if with_grad else 1, n, c, ho, wo), dtype=torch.float32,
                           device=device).unbind(0)
        ptrs = [t.data_ptr() for t in (x, y, *outs)]
        d = params.d[i]
        d.src, d.x, d.y, d.out = src.data_ptr(), ptrs[0], ptrs[1], ptrs[2]
        if with_grad:
            d.dx, d.dy = ptrs[3], ptrs[4]
        d.src_bstride, d.n, d.c = src.stride(0), n, c
        d.h_src, d.w_src, d.h_out, d.w_out = src.shape[2], src.shape[3], ho, wo
        d.vec = int(wo % 4 == 0 and all(p % 16 == 0 for p in ptrs))
        results.append((outs[0], outs[1] if with_grad else None, outs[2] if with_grad else None))
    return params, results


def sample_multi(srcs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                 ys: Sequence[torch.Tensor], with_grad: bool) -> List[Outputs]:
    """Sample each ``srcs[i]`` (N_i, C, H_i, W_i) at (``xs[i]``, ``ys[i]``)
    (N_i, h_i, w_i): one launch of the multi-plane-set kernel for up to
    ``MAX_DESCS`` plane sets of one channel count on CUDA tensors, the plain
    version on CPU tensors. Returns one (out, dx, dy) per plane set."""
    if srcs[0].device.type == "cpu":
        return sample_multi_plain(srcs, xs, ys, with_grad)
    return _sample_multi_cuda(srcs, xs, ys, with_grad)


def sample(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           with_grad: bool, group: int = 1) -> Outputs:
    """Sample ``src`` at (x, y): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Returns (out, dx, dy); dx, dy are None
    without ``with_grad``. Output plane ``i`` samples ``src[i // group]``."""
    if src.device.type == "cpu":
        return sample_plain(src, x, y, with_grad, group)
    if src.dim() == 4 and src.shape[1] == 1 and group == 1:
        return _sample_multi_cuda([src], [x], [y], with_grad)[0]
    _check(src, x, y, group)
    _, c, h, w = src.shape
    n, ho, wo = x.shape
    out = torch.empty((n, c, ho, wo), dtype=torch.float32, device=src.device)
    dx = torch.empty_like(out) if with_grad else None
    dy = torch.empty_like(out) if with_grad else None
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = _lib().colvo_bilinear_sample(
            src.data_ptr(), src.stride(0), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), dx.data_ptr() if with_grad else None,
            dy.data_ptr() if with_grad else None,
            n, c, h, w, ho, wo, int(with_grad), group, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilinear_sample kernel launch failed: cudaError {err}")
    # variants "grad/C<c>" or "value/C<c>", with "/g<group>" for a grouped launch
    key = f"S/{'grad' if with_grad else 'value'}/C{c}"
    build.count_launch(key if group == 1 else f"{key}/g{group}")
    return out, dx, dy


class _SampleCoordsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, x, y, group):
        out, dx, dy = sample(src, x, y, with_grad=True, group=group)
        ctx.save_for_backward(dx, dy)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dy = ctx.saved_tensors
        return None, (g * dx).sum(1), (g * dy).sum(1), None


def bilinear_sample_grouped_planes(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                                   group: int) -> torch.Tensor:
    """Grouped coords-gradient sampler: src (N, C, H, W), x/y (N·group, h, w)
    ordered so that plane ``i`` samples ``src[i // group]`` → (N·group, C,
    h, w). Mirrors ``colvo.kernels.bilinear_sample_fast_grouped``."""
    x, y = x.contiguous(), y.contiguous()
    if build.needs_grad(x, y):
        return _SampleCoordsGrad.apply(src, x, y, group)
    return sample(src, x, y, False, group)[0]


def bilinear_sample_planes(src: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Coords-gradient sampler on planes: src (N, C, H, W), x/y (N, h, w)
    → (N, C, h, w). The image gets no gradient (mirrors the reference)."""
    return bilinear_sample_grouped_planes(src, x, y, 1)


def bilinear_sample_fast(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), coords (B, h, w, 2) → (B, h, w, C); gradients
    flow to ``coords`` only."""
    out = bilinear_sample_planes(
        img.permute(0, 3, 1, 2).contiguous(), coords[..., 0], coords[..., 1]
    )
    return out.permute(0, 2, 3, 1)
