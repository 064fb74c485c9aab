"""Hand-written CUDA kernels for the warps of the training loss.

Two samplers, as in ``colvo/kernels/__init__.py``:

* ``bilinear_sample_fast`` — gradients to the coordinates only (frames are
  data): forward is kernel S with d/dx, d/dy; backward the channel sums
  ``gx = Σ_c g·dx``, ``gy = Σ_c g·dy``; no gradient to the image.
* ``bilinear_sample_full`` — gradients to the coordinates and the source
  (the geometric-consistency depth warp): forward is S with d/dx, d/dy,
  backward the same channel sums plus the source cotangent by kernel T.

Both choose by the tensor's device only: a CUDA tensor goes to the kernels
and a build or launch error propagates; a CPU tensor goes to the plain
PyTorch versions. Outside autograd (no grad needed) S runs its value-only
variant. ``*_planes`` variants take NCHW planes and (N, h, w) coordinate
planes and are what the loss calls; the NHWC forms keep the JAX layout.
"""

from __future__ import annotations

from typing import Dict

import torch

from colvo_torch.kernels import sampler, scatter


class _SampleCoordsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, x, y):
        out, dx, dy = sampler.sample(src, x, y, with_grad=True)
        ctx.save_for_backward(dx, dy)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dy = ctx.saved_tensors
        return None, (g * dx).sum(1), (g * dy).sum(1)


class _SampleFullGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, x, y):
        out, dx, dy = sampler.sample(src, x, y, with_grad=True)
        ctx.save_for_backward(x, y, dx, dy)
        ctx.src_hw = src.shape[2:]
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, dx, dy = ctx.saved_tensors
        d_src = None
        if ctx.needs_input_grad[0]:
            d_src = scatter.scatter(x, y, g.contiguous(), *ctx.src_hw)
        return d_src, (g * dx).sum(1), (g * dy).sum(1)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def bilinear_sample_planes(src: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Coords-gradient sampler on planes: src (N, C, H, W), x/y (N, h, w)
    → (N, C, h, w). The image gets no gradient (mirrors the reference)."""
    if _needs_grad(x, y):
        return _SampleCoordsGrad.apply(src, x.contiguous(), y.contiguous())
    return sampler.sample(src, x.contiguous(), y.contiguous(), with_grad=False)[0]


def bilinear_sample_full_planes(src: torch.Tensor, x: torch.Tensor,
                                y: torch.Tensor) -> torch.Tensor:
    """Full-gradient sampler on planes (source and coords gradients)."""
    if _needs_grad(src, x, y):
        return _SampleFullGrad.apply(src, x.contiguous(), y.contiguous())
    return sampler.sample(src, x.contiguous(), y.contiguous(), with_grad=False)[0]


def bilinear_sample_fast(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), coords (B, h, w, 2) → (B, h, w, C); gradients
    flow to ``coords`` only."""
    out = bilinear_sample_planes(
        img.permute(0, 3, 1, 2).contiguous(), coords[..., 0], coords[..., 1]
    )
    return out.permute(0, 2, 3, 1)


def bilinear_sample_full(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), coords (B, h, w, 2) → (B, h, w, C); gradients
    flow to ``img`` and ``coords``."""
    out = bilinear_sample_full_planes(
        img.permute(0, 3, 1, 2).contiguous(), coords[..., 0], coords[..., 1]
    )
    return out.permute(0, 2, 3, 1)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset: ``S/grad/C3``, ``S/value/C1``,
    ``T/C1``, ... (only CUDA launches count; the plain versions do not)."""
    counts = {f"S/{k}": v for k, v in sampler.launches.items()}
    counts.update({f"T/{k}": v for k, v in scatter.launches.items()})
    return counts


def reset_launch_counts() -> None:
    sampler.launches.clear()
    scatter.launches.clear()


__all__ = [
    "bilinear_sample_fast",
    "bilinear_sample_full",
    "bilinear_sample_planes",
    "bilinear_sample_full_planes",
    "launch_counts",
    "reset_launch_counts",
]
