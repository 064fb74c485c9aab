"""Projective-geometry ops (port of ``colvo/geometry/ops.py``).

Plain PyTorch, NHWC layout at the interface (as in the JAX package),
fully batched. These are the semantics contract for the CUDA kernels in
``colvo_torch.kernels``.

Conventions: images (B, H, W, C); depth (B, H, W); K (..., 3, 3) pinhole
intrinsics in pixels; T (..., 4, 4) target-cam → source-cam; pixel coords
``x`` = column, ``y`` = row, origin top-left.
"""

from __future__ import annotations

from typing import Tuple

import torch

# float(2**31): the smallest float whose floor no longer fits int32.
_INT32_WRAP = 2147483648.0


def disp_to_depth(
    disp: torch.Tensor, min_depth: float = 0.1, max_depth: float = 100.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid disparity → (scaled_disp, depth); disp∈[0,1] maps to
    depth∈[max_depth, min_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(
    depth: torch.Tensor, min_depth: float = 0.1, max_depth: float = 100.0
) -> torch.Tensor:
    """Inverse of :func:`disp_to_depth`."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid (H, W, 3): rows of (x, y, 1)."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def backproject(depth: torch.Tensor, k_inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W) depth + (3, 3) or (B, 3, 3) K⁻¹ → (B, H, W, 3) camera
    points ``depth · K⁻¹ · (x, y, 1)ᵀ``."""
    _, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    if k_inv.ndim == 2:
        rays = torch.einsum("ij,hwj->hwi", k_inv, grid)[None]
    else:
        rays = torch.einsum("bij,hwj->bhwi", k_inv, grid)
    return depth[..., None] * rays


def project(
    points: torch.Tensor, k: torch.Tensor, t_mat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transform (B, H, W, 3) target-camera points by (B, 4, 4) T and
    project through K. Returns (B, H, W, 2) source-pixel coords and the
    (B, H, W) projected z (the geometric-consistency "computed depth")."""
    rot = t_mat[..., :3, :3]
    trans = t_mat[..., :3, 3]
    cam = torch.einsum("bij,bhwj->bhwi", rot, points) + trans[:, None, None, :]
    if k.ndim == 2:
        uvw = torch.einsum("ij,bhwj->bhwi", k, cam)
    else:
        uvw = torch.einsum("bij,bhwj->bhwi", k, cam)
    z = uvw[..., 2]
    # Family standard: small epsilon guard on the divide (Monodepth2 uses 1e-7).
    pix = uvw[..., :2] / (z[..., None] + 1e-7)
    return pix, z


def bilinear_taps(coord: torch.Tensor, size: int):
    """Border-clamped bilinear taps along one axis: ``(i0, i1, frac)``.

    Reproduces the reference's integer semantics for every float: XLA
    converts floor(c) to int32 with saturation and then adds 1 with int32
    wraparound, so for floor(c) ≥ 2³¹ the upper tap wraps to index 0 while
    the lower clamps to ``size − 1``. torch's float→int cast does not
    saturate (on the CPU ``1e20`` becomes ``−2³¹``), so floor(c) is first
    clamped in float to ``[−1, size]``, which the border clamp cannot tell
    apart from the unclamped value, and the wrap is applied explicitly.
    The CUDA kernels use the same rule.
    """
    f = torch.floor(coord)
    frac = coord - f
    i = torch.clamp(f, -1.0, float(size)).to(torch.int64)
    i0 = torch.clamp(i, 0, size - 1)
    i1 = torch.where(f >= _INT32_WRAP, 0, torch.clamp(i + 1, 0, size - 1))
    return i0, i1, frac


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling at pixel coords with border padding.

    img (B, H, W, C); coords (B, h, w, 2) as (x, y) → (B, h, w, C). Four
    flat gathers plus lerps, differentiable in both arguments by autograd
    (the gather's transpose is a scatter-add into ``img``).
    """
    b, h, w, c = img.shape
    x0, x1, wx = bilinear_taps(coords[..., 0], w)
    y0, y1, wy = bilinear_taps(coords[..., 1], h)
    wx, wy = wx[..., None], wy[..., None]
    flat = img.reshape(b, h * w, c)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(coords.shape[:-1] + (c,))

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    return top + wy * (bot - top)


def _valid_mask(pix: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, h, w) float mask: 1 where the sample lands inside the source,
    with a 1e-3 px tolerance for float round-trip jitter at the border."""
    eps = 1e-3
    x, y = pix[..., 0], pix[..., 1]
    inside = (x >= -eps) & (x <= width - 1 + eps) & (y >= -eps) & (y <= height - 1 + eps)
    return inside.to(pix.dtype)


def inverse_warp(
    src_img: torch.Tensor,
    depth: torch.Tensor,
    t_mat: torch.Tensor,
    k: torch.Tensor,
    k_inv: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct the target by sampling the source: (warped, valid_mask)."""
    points = backproject(depth, k_inv)
    pix, z = project(points, k, t_mat)
    warped = bilinear_sample(src_img, pix)
    mask = _valid_mask(pix, src_img.shape[1], src_img.shape[2]) * (z > 0)
    return warped, mask


def reproject_depth(
    src_depth: torch.Tensor,
    tgt_depth: torch.Tensor,
    t_mat: torch.Tensor,
    k: torch.Tensor,
    k_inv: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-frame depth reprojection: (computed_depth, sampled_src_depth,
    valid_mask) for the geometric-consistency constraint."""
    points = backproject(tgt_depth, k_inv)
    pix, z = project(points, k, t_mat)
    sampled = bilinear_sample(src_depth[..., None], pix)[..., 0]
    mask = _valid_mask(pix, src_depth.shape[1], src_depth.shape[2]) * (z > 0)
    return z, sampled, mask
