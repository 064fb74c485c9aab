"""P: the training loss's backprojection → SE(3) → pinhole projection of one
depth grid to all its source frames (``csrc/project.cu``).

``project_depth`` chooses by the tensor's device: a CUDA tensor takes
kernel P (``forward``, ``backward``, which refuse other tensors; any error
raises), a CPU tensor ``project_plain``, ``geometry.ops.project(
backproject(...))`` per source, whose backward is autograd's. P's
backward sums the pose gradient's partials in a fixed order, no float
atomics: the same bits on every run. Each forward counts as ``P/fwd`` and
each backward (its pass over the pixels and the sum) as ``P/bwd``
(``kernels.launch_counts``).

The function, as ``ops.project(ops.backproject(depth, k_inv), k, t)``:
points ``depth · K⁻¹ (x, y, 1)ᵀ``, then ``K (R p + t)`` and the divide by
``z + 1e-7``. Gradients go to the depth and the transforms; K and K⁻¹ are
data.

Layout: depth (N, h, w) f32; k, k_inv (3, 3), or (N, 3, 3) (a batch of
one serves every grid); t_mats (S, N, 4, 4) f32 whose 4×4 matrices are
contiguous (the S and N strides are free, so ``t.transpose(0, 1)`` of a
(N, S, 4, 4) stack needs no copy). Outputs x, y, z (S·N, h, w): plane
``s·N + n`` is grid n seen from source s, the layout kernels S and T read.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from colvo_torch.geometry.ops import backproject, project
from colvo_torch.kernels import build

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Mats(ctypes.Structure):
    """``Mats`` of ``csrc/project.cu``, field for field: pointers and float
    strides of K, K⁻¹ (by grid; 0: one for all) and T (by source, by
    grid)."""
    _fields_ = [("k", _P), ("kinv", _P), ("t", _P), ("k_nstride", _L),
                ("kinv_nstride", _L), ("t_sstride", _L), ("t_nstride", _L)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/project.cu``'s entry
    points on a library built from it."""
    fwd = lib.colvo_project_depth_fwd
    if fwd.argtypes is None:
        fwd.argtypes = [_P, Mats, _P, _P, _P, _I, _I, _I, _I, _P]
        fwd.restype = _I
        lib.colvo_project_depth_bwd.argtypes = [_P, Mats, _P, _P, _P, _P, _P, _P,
                                                _I, _I, _I, _I, _P]
        lib.colvo_project_depth_bwd.restype = _I
        lib.colvo_project_depth_partials.argtypes = [_I, _I, _I, _I]
        lib.colvo_project_depth_partials.restype = _L
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("project"))


def project_plain(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor,
                  t_mats: torch.Tensor) -> Planes:
    """Plain version: ``ops.project(ops.backproject(depth, k_inv), k,
    t_mats[s])`` for each source, split into (S·N, h, w) planes."""
    pts = backproject(depth, k_inv)
    outs = [project(pts, k, t) for t in t_mats.unbind(0)]
    return (torch.cat([pix[..., 0] for pix, _ in outs]),
            torch.cat([pix[..., 1] for pix, _ in outs]),
            torch.cat([z for _, z in outs]))


def _grid_stride(m: torch.Tensor, n: int, what: str) -> int:
    if m.shape == (3, 3) or m.shape == (1, 3, 3):
        return 0
    if m.shape == (n, 3, 3):
        return 9
    raise ValueError(f"{what} must be (3, 3) or ({n}, 3, 3), got {tuple(m.shape)}")


def _check(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor, t_mats: torch.Tensor,
           *cotangents: torch.Tensor) -> None:
    if depth.device.type != "cuda":
        raise ValueError(f"project kernel needs CUDA tensors, got {depth.device}")
    if any(t.dtype != torch.float32 for t in (depth, k, k_inv, t_mats, *cotangents)):
        raise TypeError("project kernel takes float32 depth, intrinsics, transforms and "
                        "cotangents")
    if any(t.device != depth.device for t in (k, k_inv, t_mats, *cotangents)):
        raise ValueError("depth, intrinsics, transforms and cotangents must share one device")
    if depth.dim() != 3 or t_mats.dim() != 4 or t_mats.shape[1:] != (depth.shape[0], 4, 4):
        raise ValueError(f"bad shapes depth {tuple(depth.shape)} t_mats {tuple(t_mats.shape)}")
    plane = (t_mats.shape[0] * depth.shape[0],) + depth.shape[1:]
    if any(g.shape != plane for g in cotangents):
        raise ValueError(f"cotangents must be {plane}")
    if t_mats.stride(-1) != 1 or t_mats.stride(-2) != 4:
        raise ValueError("project kernel needs contiguous 4x4 transforms")
    if not all(t.is_contiguous() for t in (depth, k, k_inv, *cotangents)):
        raise ValueError("project kernel needs contiguous depth, intrinsics and cotangents")


def mats(k: torch.Tensor, k_inv: torch.Tensor, t_mats: torch.Tensor, n: int) -> Mats:
    """The ``Mats`` of one call on ``n`` grids."""
    return Mats(k=k.data_ptr(), kinv=k_inv.data_ptr(), t=t_mats.data_ptr(),
                k_nstride=_grid_stride(k, n, "k"), kinv_nstride=_grid_stride(k_inv, n, "k_inv"),
                t_sstride=t_mats.stride(0), t_nstride=t_mats.stride(1))


def forward(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor,
            t_mats: torch.Tensor) -> Planes:
    """x, y, z (S·N, h, w) of every source on CUDA tensors: one launch of
    the forward kernel."""
    _check(depth, k, k_inv, t_mats)
    (n, h, w), s = depth.shape, t_mats.shape[0]
    out = build.empty(3 * s * n * h * w, torch.float32, depth.device).view(3, s * n, h, w)
    x, y, z = out.unbind(0)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = _lib().colvo_project_depth_fwd(depth.data_ptr(), mats(k, k_inv, t_mats, n),
                                             x.data_ptr(), y.data_ptr(), z.data_ptr(),
                                             n, s, h, w, stream)
    if err != 0:
        raise RuntimeError(f"project kernel launch failed: cudaError {err}")
    build.count_launch("P/fwd")
    return x, y, z


def backward(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor, t_mats: torch.Tensor,
             gx: torch.Tensor, gy: torch.Tensor, gz: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cotangents of x, y, z → (d_depth (N, h, w), d_t_mats (S, N, 4, 4),
    whose bottom rows are zero) on CUDA tensors: the backward kernel, then
    the sum of its partials in a fixed order."""
    _check(depth, k, k_inv, t_mats, gx, gy, gz)
    (n, h, w), s = depth.shape, t_mats.shape[0]
    lib, device = _lib(), depth.device
    d_depth = build.empty(n * h * w, torch.float32, device).view(n, h, w)
    d_t = build.empty(s * n * 16, torch.float32, device).view(s, n, 4, 4)
    partial = build.empty(lib.colvo_project_depth_partials(n, s, h, w), torch.float32, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.colvo_project_depth_bwd(depth.data_ptr(), mats(k, k_inv, t_mats, n),
                                          gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
                                          d_depth.data_ptr(), partial.data_ptr(), d_t.data_ptr(),
                                          n, s, h, w, stream)
    if err != 0:
        raise RuntimeError(f"project backward kernel launch failed: cudaError {err}")
    build.count_launch("P/bwd")
    return d_depth, d_t


class _ProjectDepth(torch.autograd.Function):
    """Forward P; backward P's pixel pass and fixed-order sum. Only the
    inputs are saved: the backward recomputes the points."""

    @staticmethod
    def forward(ctx, depth, k, k_inv, t_mats):
        ctx.save_for_backward(depth, k, k_inv, t_mats)
        return forward(depth, k, k_inv, t_mats)

    @staticmethod
    def backward(ctx, gx, gy, gz):
        d_depth, d_t = backward(*ctx.saved_tensors, gx.contiguous(), gy.contiguous(),
                                gz.contiguous())
        return d_depth, None, None, d_t


def project_depth(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor,
                  t_mats: torch.Tensor) -> Planes:
    """Project depth (N, h, w) through K⁻¹, each of ``t_mats`` (S, N, 4, 4)
    and K ((3, 3) or (N, 3, 3)) → source-pixel x, y and projected z, each
    (S·N, h, w) with plane ``s·N + n`` for grid n and source s:
    ``geometry.ops.project(backproject(depth, k_inv), k, t_mats[s])``.
    Gradients flow to the depth and the transforms; K and K⁻¹ are data,
    and either requiring a gradient raises."""
    if build.needs_grad(k, k_inv):
        raise ValueError("project_depth takes K and K^-1 as data: neither may require a gradient")
    if depth.device.type == "cpu":
        return project_plain(depth, k, k_inv, t_mats)
    depth, k, k_inv = depth.contiguous(), k.contiguous(), k_inv.contiguous()
    if t_mats.stride(-1) != 1 or t_mats.stride(-2) != 4:
        t_mats = t_mats.contiguous()
    if build.needs_grad(depth, t_mats):
        return _ProjectDepth.apply(depth, k, k_inv, t_mats)
    return forward(depth, k, k_inv, t_mats)
