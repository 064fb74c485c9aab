"""Hand-written CUDA kernels for the warps and the fused photometric
error of the training loss, as in ``colvo/kernels/__init__.py``:

* ``bilinear_sample_fast`` — gradients to the coordinates only (frames are
  data): forward is kernel S with d/dx, d/dy; backward the channel sums
  ``gx = Σ_c g·dx``, ``gy = Σ_c g·dy``; no gradient to the image.
* ``bilinear_sample_grouped_planes`` — the same for ``group`` coordinate
  fields per source frame in one launch of S (the grouped sampler, for
  ``loss.batched_photo``): plane ``i`` samples source ``i // group``.
* ``bilinear_sample_full_multi`` — gradients to the coordinates and the
  sources of several plane sets at once (the geometric-consistency depth
  warp at every geo scale of a step): forward is one launch of S with
  d/dx, d/dy, backward the same channel sums plus the source cotangents
  by one launch of kernel T. ``bilinear_sample_full`` is its one-scale
  call.
* ``project_depth`` — the training loss's backprojection, SE(3) and
  pinhole projection of one depth grid to all its source frames: forward
  kernel P, backward P's pass over the pixels (the depth cotangent, the
  transforms' per-CTA partials) and the partials' sum in a fixed order;
  no gradient to K or K⁻¹, and no float atomics, so its gradients are the
  same bits on every run.
* ``attention`` — softmax(q·kᵀ/√d)·v of the DPT depth net's ViT blocks
  (``kernels/attention.py``): PyTorch's fused attention kernels with the
  math backend refused, counted as ``attn/fwd``.
* ``warp_photometric`` — the per-pixel warp + LCC + SSIM + L1 error of
  one source frame (``loss.fused_kernel``): kernel F's forward, and its
  backward for the coordinate cotangent, where LCC is affine or off; the
  composed sampler → ``lcc_calibrate`` → ``photometric_error`` otherwise.

All choose by the tensor's device only: a CUDA tensor goes to the kernels
and a build or launch error propagates; a CPU tensor goes to the plain
PyTorch versions. Outside autograd (no grad needed) S runs its value-only
variant and F its forward alone. ``*_planes`` variants and
``warp_photometric`` take NCHW planes and (N, h, w) coordinate planes and
are what the loss calls; the NHWC forms keep the JAX layout.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from colvo_torch.kernels import build, fused_loss, project, sampler, scatter
from colvo_torch.kernels.attention import attention


class _SampleCoordsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, x, y, group):
        out, dx, dy = sampler.sample(src, x, y, with_grad=True, group=group)
        ctx.save_for_backward(dx, dy)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dy = ctx.saved_tensors
        return None, (g * dx).sum(1), (g * dy).sum(1), None


class _FusedError(torch.autograd.Function):
    """Forward F (P7), backward F's coordinate cotangent (P8). Only the
    inputs are saved: the backward recomputes the warp and the window
    statistics instead of keeping them in memory."""

    @staticmethod
    def forward(ctx, src, tgt, x, y, lcc_window, alpha):
        ctx.save_for_backward(src, tgt, x, y)
        ctx.cfg = (lcc_window, alpha)
        return fused_loss.err(src, tgt, x, y, lcc_window, alpha)

    @staticmethod
    def backward(ctx, g):
        src, tgt, x, y = ctx.saved_tensors
        gx, gy = fused_loss.err_bwd(src, tgt, x, y, g.contiguous(), *ctx.cfg)
        return None, None, gx, gy, None, None


class _SampleFullGradMulti(torch.autograd.Function):
    """``apply(*srcs, *xs, *ys)`` → one output per plane set. Forward: one
    launch of S with d/dx, d/dy; backward: one launch of T for the sources
    that need a gradient, and the coordinate channel sums."""

    @staticmethod
    def forward(ctx, *args):
        k = len(args) // 3
        srcs, xs, ys = args[:k], args[k:2 * k], args[2 * k:]
        res = sampler.sample_multi(srcs, xs, ys, with_grad=True)
        ctx.save_for_backward(*xs, *ys, *(r[1] for r in res), *(r[2] for r in res))
        ctx.src_hws = [tuple(s.shape[2:]) for s in srcs]
        return tuple(r[0] for r in res)

    @staticmethod
    def backward(ctx, *gs):
        k = len(gs)
        saved = ctx.saved_tensors
        xs, ys, dxs, dys = (saved[i * k:(i + 1) * k] for i in range(4))
        d_srcs: List = [None] * k
        need = [i for i in range(k) if ctx.needs_input_grad[i]]
        if need:
            got = scatter.scatter_multi([xs[i] for i in need], [ys[i] for i in need],
                                        [gs[i].contiguous() for i in need],
                                        [ctx.src_hws[i] for i in need])
            for i, d in zip(need, got):
                d_srcs[i] = d
        gxs = [(g * dx).sum(1) for g, dx in zip(gs, dxs)]
        gys = [(g * dy).sum(1) for g, dy in zip(gs, dys)]
        return (*d_srcs, *gxs, *gys)


class _ProjectDepth(torch.autograd.Function):
    """Forward P; backward P's pixel pass and fixed-order sum. Only the
    inputs are saved: the backward recomputes the points."""

    @staticmethod
    def forward(ctx, depth, k, k_inv, t_mats):
        ctx.save_for_backward(depth, k, k_inv, t_mats)
        return project.forward(depth, k, k_inv, t_mats)

    @staticmethod
    def backward(ctx, gx, gy, gz):
        d_depth, d_t = project.backward(*ctx.saved_tensors, gx.contiguous(), gy.contiguous(),
                                        gz.contiguous())
        return d_depth, None, None, d_t


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def bilinear_sample_planes(src: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Coords-gradient sampler on planes: src (N, C, H, W), x/y (N, h, w)
    → (N, C, h, w). The image gets no gradient (mirrors the reference)."""
    if _needs_grad(x, y):
        return _SampleCoordsGrad.apply(src, x.contiguous(), y.contiguous(), 1)
    return sampler.sample(src, x.contiguous(), y.contiguous(), with_grad=False)[0]


def bilinear_sample_grouped_planes(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                                   group: int) -> torch.Tensor:
    """Grouped coords-gradient sampler: src (N, C, H, W), x/y (N·group, h, w)
    ordered so that plane ``i`` samples ``src[i // group]`` → (N·group, C,
    h, w). Mirrors ``colvo.kernels.bilinear_sample_fast_grouped``."""
    if _needs_grad(x, y):
        return _SampleCoordsGrad.apply(src, x.contiguous(), y.contiguous(), group)
    return sampler.sample(src, x.contiguous(), y.contiguous(), False, group)[0]


def warp_photometric(src: torch.Tensor, tgt: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, lcc_mode: str, lcc_window: int,
                     alpha: float) -> torch.Tensor:
    """Per-pixel photometric error (N, h, w) of ``src`` (N, C, H, W) warped
    to (x, y) against ``tgt`` (N, C, h, w); gradients flow to x and y only.
    Mirrors ``colvo.kernels.warp_photometric_fast``: kernel F where LCC is
    affine or off and α > 0, else the composed path, whose LCC pools no
    valid mask."""
    x, y = x.contiguous(), y.contiguous()
    if lcc_mode in ("affine", "off") and alpha > 0.0:
        window = lcc_window if lcc_mode == "affine" else 0
        if _needs_grad(x, y):
            return _FusedError.apply(src, tgt, x, y, window, alpha)
        return fused_loss.err(src, tgt, x, y, window, alpha)
    # imported here: colvo_torch.losses imports this package
    from colvo_torch.losses.photometric import lcc_calibrate, photometric_error

    warped = bilinear_sample_planes(src, x, y).permute(0, 2, 3, 1)
    tgt = tgt.permute(0, 2, 3, 1)
    if lcc_mode != "off":
        warped = lcc_calibrate(warped, tgt, lcc_mode, lcc_window)
    return photometric_error(warped, tgt, alpha)


def bilinear_sample_full_multi(srcs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                               ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Full-gradient sampler over several plane sets in one launch each
    way: ``srcs[i]`` (N_i, C, H_i, W_i) at ``xs[i]``, ``ys[i]`` (N_i, h_i,
    w_i) → one (N_i, C, h_i, w_i) output per plane set, with gradients to
    the sources and the coordinates."""
    xs = [x.contiguous() for x in xs]
    ys = [y.contiguous() for y in ys]
    if _needs_grad(*srcs, *xs, *ys):
        return list(_SampleFullGradMulti.apply(*srcs, *xs, *ys))
    return [r[0] for r in sampler.sample_multi(srcs, xs, ys, with_grad=False)]


def bilinear_sample_full_planes(src: torch.Tensor, x: torch.Tensor,
                                y: torch.Tensor) -> torch.Tensor:
    """Full-gradient sampler on planes (source and coords gradients)."""
    return bilinear_sample_full_multi([src], [x], [y])[0]


def project_depth(depth: torch.Tensor, k: torch.Tensor, k_inv: torch.Tensor,
                  t_mats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project depth (N, h, w) through K⁻¹, each of ``t_mats`` (S, N, 4, 4)
    and K ((3, 3) or (N, 3, 3)) → source-pixel x, y and projected z, each
    (S·N, h, w) with plane ``s·N + n`` for grid n and source s:
    ``geometry.ops.project(backproject(depth, k_inv), k, t_mats[s])``.
    Gradients flow to the depth and the transforms; K and K⁻¹ are data,
    and either requiring a gradient raises."""
    if _needs_grad(k, k_inv):
        raise ValueError("project_depth takes K and K^-1 as data: neither may require a gradient")
    if depth.device.type == "cpu":
        return project.project_plain(depth, k, k_inv, t_mats)
    depth, k, k_inv = depth.contiguous(), k.contiguous(), k_inv.contiguous()
    if t_mats.stride(-1) != 1 or t_mats.stride(-2) != 4:
        t_mats = t_mats.contiguous()
    if _needs_grad(depth, t_mats):
        return _ProjectDepth.apply(depth, k, k_inv, t_mats)
    return project.forward(depth, k, k_inv, t_mats)


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
    """Kernel launches since the last reset: ``S/grad/C3``,
    ``S/grad/C3/g4``, ``S/value/C1``, ``T/C1``, ``F/fwd/C3``, ``F/bwd/C3``,
    ``P/fwd``, ``P/bwd``, ``attn/fwd``, ... (only CUDA launches count; the
    plain versions do not). They are the counters ``launch.<key>`` of
    ``runtime.spans``, which count whether it records or not
    (``spans.tally``)."""
    from colvo_torch.runtime import spans  # the runtime package imports this one

    return {k[len(build.LAUNCH):]: v for k, v in spans.counters(build.LAUNCH).items()}


def reset_launch_counts() -> None:
    from colvo_torch.runtime import spans

    spans.reset_counters(build.LAUNCH)


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` (keyed as ``launch_counts`` gives them):
    the launches of a CUDA graph replayed ``times`` times. The wrappers
    count a launch where Python calls them, so a captured launch is
    counted at capture, which launches nothing, and not at a replay."""
    from colvo_torch.runtime import spans

    for key, n in counts.items():
        spans.tally(build.LAUNCH + key, n * times)


__all__ = [
    "attention",
    "bilinear_sample_fast",
    "bilinear_sample_full",
    "bilinear_sample_planes",
    "bilinear_sample_full_planes",
    "bilinear_sample_full_multi",
    "bilinear_sample_grouped_planes",
    "warp_photometric",
    "project_depth",
    "launch_counts",
    "reset_launch_counts",
    "add_launch_counts",
]
