#!/usr/bin/env python3
"""GPU smoke test of ``colvo_torch`` (the PyTorch/CUDA port), run from the
repository root with one CUDA card: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the CUDA kernels from ``colvo_torch/kernels/csrc`` (one ``nvcc``
   per source, in parallel).
3. Kernel phase: at the training paths' shapes, holds kernel S (bilinear
   sampler, with and without d/dx, d/dy; C=3 photometric, C=1 at the four
   geo scales in one multi-plane-set launch, also at an odd width and
   under a wild warp, and grouped: 4 coordinate fields per source frame),
   kernel T (source-cotangent scatter, one launch for the four geo scales,
   also at an odd width and under a wild warp) and kernel F (fused warp+LCC+SSIM+L1
   error, forward and coordinate backward) against their plain PyTorch
   versions on the card, F also at a shape that cuts its tiles and at
   windows 0, 4 and 15; times kernel, plain version and the nearest single
   PyTorch call on the device (CUDA-graph replays between CUDA events),
   the kernel's eager call through its wrapper, and F with the L2 flushed
   before each call. Every kernel's registers and spills come from the
   build's ``ptxas`` report; a spill fails the run.
4. Slice phase, three times: ``ColvoConfig`` at full width (ResNet-18,
   B=12, 256×320, 3 frames, 4 scales, bf16 convs) by default, with
   ``loss.fused_kernel`` and with ``loss.batched_photo``, each from the same
   initial weights, trains for a few steps on rendered synthetic snippets,
   then evaluates the loss on a held-out batch without gradients. Losses
   and the gradient norm must be finite, the launch counters must equal
   the launches the path makes, step 1's loss terms must agree with a
   recomputation that swaps the kernels for their plain versions on the
   same weights and batch, and with the default path's step 1. One more
   step runs under ``torch.profiler``: device time by kernel and by
   bucket, the device's busy share, peak memory.
5. Serving phase, after the default path's steps:
   ``InferenceRunner.infer_coupled`` on frame pairs.
6. VO phase, on the same weights: ``run_vo`` streams a rendered 64-frame
   sequence at full width (uint8 RGB in, float16 wire); its trajectory
   and depths must be sane, its float32 wire must agree with per-pair
   ``infer_coupled``, the float16 and uint8 wires and I420 input must stay
   within their bounds, symmetric pose must keep the forward translation,
   and the native pose chain must equal the numpy one. ATE/RPE, polyp
   errors and a stitched cloud (with a PLY round trip) follow, as in the
   reference's ``evaluate_synthetic``; no kernel may launch. Then
   frames/s of each input format and wire (at least 30), the layers of
   one chunk, the card's busy share and peak memory.
7. Loop phase: the training entry point at full width, in process through
   ``colvo_torch.cli``: ``train`` for 8 steps on the synthetic dataset
   (metrics every 2 steps, checkpoints every 4, the profiler over steps
   5-7, the eval hook at step 7), ``export``, ``train --resume`` to step
   10. The metrics rows, the eval hook's panels, the checkpoints, the
   resume, the step-8 checkpoint against the live state bit for bit, the
   export and run 1's launch counts (the slice's per step, times 8) are
   checked; loop ms/step against the slice's, the card's busy share over
   the profiled steps, peak memory and the producer thread's ms a batch
   are printed. Then the dispatch-side NaN stop and a basin restart at
   64×96.
8. Device-loader phase: run 3 of ``cli train`` with ``data.loader=device``
   on the loop phase's dataset, as run 1 and checked as it is, with its
   ms/step beside run 1's, the interval between steps, the busy share,
   peak memory and the store's upload; a store of 100 × 100 frames at
   256×320 (2.46 GB of uint8, tiled): its upload, one batch's gather +
   augment, its memory; ``make_scan_train`` at K=4 against 4 eager train
   steps fed the same indices and augmentation draws (step 1's loss terms
   to 1e-3 relative), 3 replays (the counter, fresh indices, launches =
   captured × replays), the chunk's ms/step, busy share and peak memory.
9. Prints the kernel table as one JSON line (launches over the slice
   runs, loop run 1, the device-loader run and the chunk's checked
   replays), then the device line ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails without a CUDA card, or where ``colvo_torch`` is absent.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from colvo_torch.config import ColvoConfig  # noqa: E402
from colvo_torch.data import batch_iterator, synthetic_dataset  # noqa: E402
from colvo_torch.kernels import build, launch_counts, reset_launch_counts  # noqa: E402
from colvo_torch.kernels import fused_loss, sampler, scatter  # noqa: E402
from colvo_torch.losses.photometric import lcc_calibrate  # noqa: E402
from colvo_torch.runtime import InferenceRunner, init_state, loss_fn, to_device, train_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

PHOTO = (12, 3, 256, 320)  # B, C, H, W of the photometric warp
GEO_N = 24  # S·B depth planes of the stacked geo warp
GEO_SCALES = ((256, 320), (128, 160), (64, 80), (32, 40))
GEO_ODD = (37, 53)  # a geo plane shape whose width takes S's one-pixel-a-thread path
GEO_REPS = 10  # calls a CUDA graph in the per-scale times of the geo kernels
GROUP = 4  # coordinate fields per source frame of the grouped sampler (n_scales)
LCC_WINDOW, ALPHA = 15, 0.85
TOL_VALUE, TOL_GRAD, TOL_SCATTER_REL = 1e-5, 1e-4, 1e-4
TOL_GROUPED = 1e-6  # P6 value and d/dx, d/dy, abs
TOL_FUSED_FWD, TOL_FUSED_BWD_REL = 5e-5, 1e-4
# P8 is discontinuous where ŵ = t in a channel (the L1 term's sign): within
# TIE_GAP of that, float32 rounding may put kernel and plain version on
# opposite sides. Such pixels are compared on no tolerance, and may be at
# most MAX_TIE_SHARE of all.
TIE_GAP, MAX_TIE_SHARE = 1e-5, 1e-3
# F is also held at a shape that cuts every strip, chunk and row range of
# its grid and puts the image edges inside the windows, from a source of
# another size, and at each of these windows (0: no LCC; 4: even, lo ≠ hi).
FUSED_SEAM = ((2, 3, 150, 70), (97, 131))
FUSED_WINDOWS = (0, 4, LCC_WINDOW)
FLUSH_BYTES = 64 * 2**20  # more than the H100's 50 MB L2
TRAIN_STEPS = 6
# f32 operations of F per output pixel: the tap arithmetic once, and per
# channel the lerps (6), the four window-L sums taken separably with the
# two products (2 + 8·(L−1)), the LCC statistics and ŵ (17), the five 3×3
# sums taken separably with three products (3 + 20), the SSIM moments and
# value (23) and the L1 and channel sums (4); the backward adds per channel
# the coordinate derivatives (4), the SSIM terms G1-G3 and F1-F3 (30), the
# three 3×3 transposed sums (12), dŵ, dw and the two channel sums (12).
F_TAP_OPS = 12
F_FWD_OPS = 6 + 2 + 8 * (LCC_WINDOW - 1) + 17 + 3 + 20 + 23 + 4
F_BWD_OPS = F_FWD_OPS + 4 + 30 + 12 + 12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """Device time of one ``fn()``: warmed up on a side stream, captured
    ``reps`` times into a CUDA graph and replayed ``iters`` times between
    CUDA events, so Python dispatch stays out of the clock. With ``reps`` >
    1 the host's rate of replays cannot set the time of a short call."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _events_ms(graph.replay, iters) / reps


def cold_ms(fn, flush: torch.Tensor) -> float:
    """Device time of one ``fn()`` with a cold L2: CUDA-graph replays of
    (writing all of ``flush``, ``fn()``) less those of the write alone."""
    fill = lambda: flush.fill_(1.0)  # noqa: E731
    return time_ms(lambda: (fill(), fn())) - time_ms(fill)


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager ``fn()`` call by CUDA events: where the host's
    dispatch is slower than the device, this is the host's time."""
    for _ in range(warmup):
        fn()
    return _events_ms(fn, iters)


def bound(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def make_coords(n: int, h: int, w: int, seed: int, device) -> tuple:
    """Smooth random warps (zoom + shift + low-frequency wobble), a band
    of out-of-bounds coords along the top rows and left columns, and
    scattered ±1e20 and 3e9 coords."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    xs, ys = [], []
    for _ in range(n):
        zoom = rng.uniform(0.95, 1.05)
        ph = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.5, 3.0) * w / 320
        x = (gx - w / 2) * zoom + w / 2 + rng.uniform(-4, 4) + amp * np.sin(
            2 * np.pi * gy / h + ph[0])
        y = (gy - h / 2) * zoom + h / 2 + rng.uniform(-4, 4) + amp * np.sin(
            2 * np.pi * gx / w + ph[1])
        band = max(h // 32, 1)
        x[:band] = rng.uniform(-60, w + 60, (band, w))
        y[:, :band] = rng.uniform(-60, h + 60, (h, band))
        idx = rng.integers(0, h * w, 24)
        x.reshape(-1)[idx[:6]], x.reshape(-1)[idx[6:12]] = 1e20, -1e20
        y.reshape(-1)[idx[12:18]], y.reshape(-1)[idx[18:]] = 1e20, -1e20
        x.reshape(-1)[idx[0] // 2] = 3e9
        xs.append(x)
        ys.append(y)
    t = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(device)  # noqa: E731
    return t(xs), t(ys)


def _norm_grid(x, y, h, w):
    return torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], dim=-1)


def kernel_phase(device, photo=PHOTO, geo_n=GEO_N, geo_scales=GEO_SCALES, group=GROUP,
                 timed=True):
    """Hold S, T and F against their plain versions; returns the kernel
    rows (without launch counts) keyed P1..P8."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(0)
    timer = time_ms if timed else (lambda fn, **kw: float("nan"))
    eager = eager_ms if timed else (lambda fn, **kw: float("nan"))
    flush = torch.empty(FLUSH_BYTES // 4, device=device) if timed else None
    cold = (lambda fn: cold_ms(fn, flush)) if timed else (lambda fn: float("nan"))
    rows = {}

    # Photometric warp: C=3 frames, value + dx + dy (P1) and value only (P2).
    b, c, h, w = photo
    src = torch.rand(photo, generator=gen).to(device)
    x, y = make_coords(b, h, w, 1, device)
    out, dx, dy = sampler.sample(src, x, y, True)
    pout, pdx, pdy = sampler.sample_plain(src, x, y, True)
    err_v = (out - pout).abs().max().item()
    err_g = max((dx - pdx).abs().max().item(), (dy - pdy).abs().max().item())
    vout = sampler.sample(src, x, y, False)[0]
    err_nv = (vout - pout).abs().max().item()
    log(f"S photo C={c}: |value| {err_v:.3g}  |dx,dy| {err_g:.3g}  |value-only| {err_nv:.3g}")
    check(err_v <= TOL_VALUE and err_g <= TOL_GRAD and err_nv <= TOL_VALUE, "S photo vs plain")
    check(bool(torch.isfinite(out).all() and torch.isfinite(dx).all()), "S photo finite")
    px = b * h * w
    grid = _norm_grid(x, y, h, w)
    rows["P1"] = dict(
        max_abs_err=max(err_v, err_g),
        ms=timer(lambda: sampler.sample(src, x, y, True)),
        eager_ms=eager(lambda: sampler.sample(src, x, y, True)),
        plain_ms=timer(lambda: sampler.sample_plain(src, x, y, True)),
        library_ms=None,
        bound=bound(4 * (src.numel() + 2 * px + 3 * px * c), px * (12 + 11 * c)),
    )
    rows["P2"] = dict(
        max_abs_err=err_nv,
        ms=timer(lambda: sampler.sample(src, x, y, False)),
        eager_ms=eager(lambda: sampler.sample(src, x, y, False)),
        plain_ms=timer(lambda: sampler.sample_plain(src, x, y, False)),
        library_ms=timer(lambda: F.grid_sample(src, grid, "bilinear", "border", True)),
        bound=bound(4 * (src.numel() + 2 * px + px * c), px * (12 + 6 * c)),
    )

    rows.update(geo_rows(device, gen, geo_n, geo_scales, timer, eager))
    rows.update(grouped_rows(device, gen, photo, group, timer, eager))
    rows.update(fused_rows(device, gen, photo, timer, eager, cold))
    torch.backends.cudnn.allow_tf32 = True
    return rows


def geo_parity(ds, xs, ys, gs):
    """The multi-plane-set S (grad and value) and T against their plain
    versions over the plane sets ``ds``; returns the P3, P4 and P5 errors
    and T's error over max|d_src|."""
    got = sampler.sample_multi(ds, xs, ys, True)
    want = sampler.sample_multi_plain(ds, xs, ys, True)
    value = sampler.sample_multi(ds, xs, ys, False)
    hws = [tuple(d.shape[2:]) for d in ds]
    d_src = scatter.scatter_multi(xs, ys, gs, hws)
    p_src = scatter.scatter_multi_plain(xs, ys, gs, hws)
    err = {"P3": 0.0, "P4": 0.0, "P5": 0.0, "P5_rel": 0.0}
    for (o, ddx, ddy), (po, pdx, pdy), (vo, _, _), ds_, ps in zip(got, want, value, d_src, p_src):
        err_v = (o - po).abs().max().item()
        err_g = max((ddx - pdx).abs().max().item(), (ddy - pdy).abs().max().item())
        check(err_v <= TOL_VALUE, "S geo value vs plain")
        check(err_g <= TOL_GRAD, "S geo d/dx, d/dy vs plain")
        check(bool(torch.isfinite(o).all() and torch.isfinite(ddx).all()), "S geo finite")
        check(bool(torch.isfinite(ds_).all()), "T finite")
        e5 = (ds_ - ps).abs().max().item()
        err["P3"] = max(err["P3"], err_v, err_g)
        err["P4"] = max(err["P4"], (vo - po).abs().max().item())
        err["P5"] = max(err["P5"], e5)
        err["P5_rel"] = max(err["P5_rel"], e5 / ps.abs().max().item())
    check(err["P4"] <= TOL_VALUE and err["P5_rel"] <= TOL_SCATTER_REL,
          "S geo value-only, T vs plain")
    return err


def geo_rows(device, gen, geo_n, geo_scales, timer, eager):
    """P3, P4, P5: the geo warp's C=1 depth planes at the four scales, each
    kernel one multi-plane-set launch for all of them, against the plain
    versions; also at ``GEO_ODD`` (the scalar path of S) and under a wild
    warp at the two largest scales (no two of T's terms join). Timed as the
    one launch, with the single-scale calls' times logged beside it."""
    geo = []
    for i, (gh, gw) in enumerate(geo_scales):
        d = (0.01 + torch.rand((geo_n, 1, gh, gw), generator=gen)).to(device)
        gx, gy = make_coords(geo_n, gh, gw, 10 + i, device)
        g = torch.randn((geo_n, 1, gh, gw), generator=gen).to(device)
        g[:, :, : gh // 8] = 0.0  # zero cotangent where the loss masks pixels
        geo.append((d, gx, gy, g))
    ds, xs, ys, gs = (list(t) for t in zip(*geo))
    hws = [tuple(d.shape[2:]) for d in ds]
    err = geo_parity(ds, xs, ys, gs)
    log(f"S geo C=1, {len(geo)} scales in one launch: |value,dx,dy| {err['P3']:.3g}  "
        f"|value-only| {err['P4']:.3g};  T: |d_src| {err['P5']:.3g}, "
        f"/ max|d_src| {err['P5_rel']:.3g}")

    # The scalar path of S (an odd width) and a warp under which T joins
    # nothing (coords uniform over the image), in one launch each way.
    edge = []
    oh, ow = GEO_ODD
    d = (0.01 + torch.rand((geo_n, 1, oh, ow), generator=gen)).to(device)
    edge.append((d, *make_coords(geo_n, oh, ow, 20, device)))
    for gh, gw in geo_scales[:2]:
        d = (0.01 + torch.rand((geo_n, 1, gh, gw), generator=gen)).to(device)
        wx = (torch.rand((geo_n, gh, gw), generator=gen) * (gw + 2) - 1).to(device)
        wy = (torch.rand((geo_n, gh, gw), generator=gen) * (gh + 2) - 1).to(device)
        edge.append((d, wx, wy))
    e_ds, e_xs, e_ys = (list(t) for t in zip(*edge))
    e_gs = [torch.randn(d.shape, generator=gen).to(device) for d in e_ds]
    e_err = geo_parity(e_ds, e_xs, e_ys, e_gs)
    log(f"S geo C=1 at {oh}x{ow} and a wild warp at {geo_scales[0]}, {geo_scales[1]}: "
        f"|value,dx,dy| {e_err['P3']:.3g}  |value-only| {e_err['P4']:.3g};  T: |d_src| "
        f"{e_err['P5']:.3g}, / max|d_src| {e_err['P5_rel']:.3g}")
    for k in ("P3", "P4", "P5"):
        err[k] = max(err[k], e_err[k])

    s_grad = lambda: sampler.sample_multi(ds, xs, ys, True)  # noqa: E731
    s_value = lambda: sampler.sample_multi(ds, xs, ys, False)  # noqa: E731
    t_all = lambda: scatter.scatter_multi(xs, ys, gs, hws)  # noqa: E731
    if timer is time_ms:
        # GEO_REPS calls a graph, so that the host's replay rate does not
        # set the time of the short single-scale calls
        rep = lambda fn: time_ms(fn, reps=GEO_REPS)  # noqa: E731
        per = []
        for d, gx, gy, g in geo:
            per.append((rep(lambda: sampler.sample(d, gx, gy, True)),
                        rep(lambda: sampler.sample(d, gx, gy, False)),
                        rep(lambda: scatter.scatter(gx, gy, g, *d.shape[2:]))))
        log(f"geo kernels, {GEO_REPS} calls a CUDA graph (ms a call; S grad / S value / T): "
            "one scale a call " + ", ".join(
                f"{h}x{w} {a:.4f}/{b:.4f}/{c:.4f}" for (h, w), (a, b, c) in zip(hws, per))
            + "; their sum " + "/".join(f"{sum(t):.4f}" for t in zip(*per))
            + f"; all scales in one call {rep(s_grad):.4f}/{rep(s_value):.4f}/{rep(t_all):.4f}")
    gpx = sum(x.numel() for x in xs)
    gsrc = sum(d.numel() for d in ds)
    grids = [_norm_grid(gx, gy, *d.shape[2:]) for d, gx, gy, _ in geo]
    return {
        "P3": dict(
            max_abs_err=err["P3"],
            ms=timer(s_grad),
            eager_ms=eager(s_grad),
            plain_ms=timer(lambda: sampler.sample_multi_plain(ds, xs, ys, True)),
            library_ms=None,
            bound=bound(4 * (gsrc + 5 * gpx), 23 * gpx),
        ),
        "P4": dict(
            max_abs_err=err["P4"],
            ms=timer(s_value),
            eager_ms=eager(s_value),
            plain_ms=timer(lambda: sampler.sample_multi_plain(ds, xs, ys, False)),
            library_ms=timer(lambda: [F.grid_sample(d, gr, "bilinear", "border", True)
                                      for d, gr in zip(ds, grids)]),
            bound=bound(4 * (gsrc + 3 * gpx), 18 * gpx),
        ),
        "P5": dict(
            max_abs_err=err["P5"],
            ms=timer(t_all),
            eager_ms=eager(t_all),
            plain_ms=timer(lambda: scatter.scatter_multi_plain(xs, ys, gs, hws)),
            library_ms=timer(lambda: [torch.ops.aten.grid_sampler_2d_backward(
                g, d, gr, 0, 1, True, [True, False]) for d, g, gr in zip(ds, gs, grids)]),
            bound=bound(4 * (3 * gpx + gsrc), 24 * gpx),
        ),
    }


def grouped_rows(device, gen, photo, group, timer, eager):
    """P6: the grouped sampler at the batched photometric stack (S·B source
    frames, ``group`` scale-minor coordinate fields each)."""
    b, c, h, w = photo
    src = torch.rand((2 * b, c, h, w), generator=gen).to(device)
    n = src.shape[0] * group
    x, y = make_coords(n, h, w, 2, device)
    out, dx, dy = sampler.sample(src, x, y, True, group)
    pout, pdx, pdy = sampler.sample_plain(src, x, y, True, group)
    err_v = (out - pout).abs().max().item()
    err_g = max((dx - pdx).abs().max().item(), (dy - pdy).abs().max().item())
    err_nv = (sampler.sample(src, x, y, False, group)[0] - pout).abs().max().item()
    log(f"S grouped C={c} x{group}: |value| {err_v:.3g}  |dx,dy| {err_g:.3g}  "
        f"|value-only| {err_nv:.3g}")
    check(max(err_v, err_g, err_nv) <= TOL_GROUPED, "S grouped vs plain")
    check(bool(torch.isfinite(out).all() and torch.isfinite(dx).all()), "S grouped finite")
    # F.grid_sample's input is the source repeated ``group`` times, made
    # outside the clock
    rep, grid = src.repeat_interleave(group, 0), _norm_grid(x, y, h, w)
    px = n * h * w
    log(f"S grouped value-only: {timer(lambda: sampler.sample(src, x, y, False, group)):.4f} ms")
    return {"P6": dict(
        max_abs_err=max(err_v, err_g, err_nv),
        ms=timer(lambda: sampler.sample(src, x, y, True, group)),
        eager_ms=eager(lambda: sampler.sample(src, x, y, True, group)),
        plain_ms=timer(lambda: sampler.sample_plain(src, x, y, True, group)),
        library_ms=timer(lambda: F.grid_sample(rep, grid, "bilinear", "border", True)),
        bound=bound(4 * (src.numel() + 2 * px + 3 * px * c), px * (12 + 11 * c)),
    )}


def fused_inputs(gen, shape, src_hw, seed, device):
    """Frames, coords (scaled to the source's size) and cotangent for F.
    The target relights the source where the two have one size, so the LCC
    fit has something to find; else it relights fresh noise."""
    b, c, h, w = shape
    src = torch.rand((b, c) + tuple(src_hw), generator=gen).to(device)
    base = src if tuple(src_hw) == (h, w) else torch.rand(shape, generator=gen).to(device)
    tgt = (0.8 * base + 0.1 + 0.05 * torch.rand(shape, generator=gen).to(device)).clamp(0, 1)
    x, y = make_coords(b, h, w, seed, device)
    x, y = x * (src_hw[1] / w), y * (src_hw[0] / h)
    g = torch.randn((b, h, w), generator=gen).to(device)
    g[:, : h // 8] = 0.0  # zero cotangent where the loss masks pixels
    return (src, tgt, x.contiguous(), y.contiguous()), g


def fused_parity(args, g, window):
    """P7 and P8 against their plain versions: |e| abs, |gx, gy| off the L1
    sign ties, abs and over max|gx, gy|, and the mask of those ties."""
    src, tgt, x, y = args
    e = fused_loss.err(*args, window, ALPHA)
    err_f = (e - fused_loss.err_plain(*args, window, ALPHA)).abs().max().item()
    gx, gy = fused_loss.err_bwd(*args, g, window, ALPHA)
    pgx, pgy = fused_loss.err_bwd_plain(*args, g, window, ALPHA)
    diff = torch.maximum((gx - pgx).abs(), (gy - pgy).abs())
    scale = max(pgx.abs().max().item(), pgy.abs().max().item())
    t = tgt.permute(0, 2, 3, 1)
    w_hat = sampler.sample_plain(src, x, y, False)[0].permute(0, 2, 3, 1)
    if window:
        w_hat = lcc_calibrate(w_hat, t, "affine", window)
    ties = (w_hat - t).abs().amin(-1) < TIE_GAP
    err_b = diff[~ties].max().item()
    check(bool(torch.isfinite(e).all() and torch.isfinite(gx).all() and torch.isfinite(gy).all()),
          "F finite")
    return err_f, err_b, err_b / scale, ties


def fused_rows(device, gen, photo, timer, eager, cold):
    """P7, P8: the fused error map and its coordinate cotangent against
    their plain versions at the per-source photometric shape and at
    ``FUSED_SEAM``, each at ``FUSED_WINDOWS``; timed at the photometric
    shape and ``LCC_WINDOW``, with a warm and a cold L2."""
    b, c, h, w = photo
    main = fused_inputs(gen, photo, (h, w), 3, device)
    worst = {"P7": 0.0, "P8": 0.0}
    for shape, src_hw in ((photo, (h, w)), FUSED_SEAM):
        args, g = main if shape == photo else fused_inputs(gen, shape, src_hw, 4, device)
        for window in FUSED_WINDOWS:
            err_f, err_b, rel_b, ties = fused_parity(args, g, window)
            log(f"F {tuple(shape)} src {tuple(src_hw)} L={window}: |e| {err_f:.3g};  |gx,gy| "
                f"{err_b:.3g}, / max|gx,gy| {rel_b:.3g} off the {int(ties.sum())} pixels within "
                f"{TIE_GAP:g} of an L1 sign change")
            check(err_f <= TOL_FUSED_FWD and rel_b <= TOL_FUSED_BWD_REL,
                  f"F vs plain at {tuple(shape)}, L={window}")
            check(ties.float().mean().item() <= MAX_TIE_SHARE, "F bwd: share of L1 sign ties")
            worst["P7"], worst["P8"] = max(worst["P7"], err_f), max(worst["P8"], err_b)
    args, g = main
    px = b * h * w
    frames = args[0].numel() + args[1].numel()
    fwd = lambda: fused_loss.err(*args, LCC_WINDOW, ALPHA)  # noqa: E731
    bwd = lambda: fused_loss.err_bwd(*args, g, LCC_WINDOW, ALPHA)  # noqa: E731
    rows = {
        "P7": dict(
            max_abs_err=worst["P7"],
            ms=timer(fwd),
            cold_ms=cold(fwd),
            eager_ms=eager(fwd),
            plain_ms=timer(lambda: fused_loss.err_plain(*args, LCC_WINDOW, ALPHA)),
            library_ms=None,
            bound=bound(4 * (frames + 3 * px), px * (F_TAP_OPS + F_FWD_OPS * c)),
        ),
        "P8": dict(
            max_abs_err=worst["P8"],
            ms=timer(bwd),
            cold_ms=cold(bwd),
            eager_ms=eager(bwd),
            plain_ms=timer(lambda: fused_loss.err_bwd_plain(*args, g, LCC_WINDOW, ALPHA)),
            library_ms=None,
            bound=bound(4 * (frames + 5 * px), px * (F_TAP_OPS + F_BWD_OPS * c)),
        ),
    }
    log(f"F with the L2 flushed before each call: P7 {rows['P7']['cold_ms']:.4f} ms (warm "
        f"{rows['P7']['ms']:.4f}), P8 {rows['P8']['cold_ms']:.4f} ms (warm {rows['P8']['ms']:.4f})")
    return rows


def kernel_ptxas() -> None:
    """Logs every kernel's registers and stack frame from the builds'
    ``ptxas -v`` reports, and fails if any kernel spills. A stack frame
    in a multi-plane-set kernel would mean its descriptor table is copied
    to local memory, not read where it was passed."""
    for source in build.SOURCES:
        report = build.ptxas_report(source)
        entries = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                             r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                             r"Used (\d+) registers", report, re.S)
        check(len(entries) >= {"sampler": 4, "scatter": 1}.get(source, 2),
              f"ptxas report of {source}.cu lists its kernels:\n{report}")
        regs = {}
        for name, stack, stores, loads, n_regs in entries:
            kind = re.search(r"\d+([a-z_]+)_kernel", name)  # the identifier in the mangled name
            nc = re.search(r"_kernelILi(\d+)E|_kernelILb(\d)E", name)
            tag = (kind.group(1) if kind else name[:24]) + (
                f" <{nc.group(1) or nc.group(2)}>" if nc else "")
            regs[tag] = f"{n_regs} registers" + (f", {stack} B stack" if int(stack) else "")
            check(int(stores) == 0 and int(loads) == 0, f"kernel {name} spills")
        log(f"{source}.cu kernels (ptxas -v, sm_90a): "
            + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())) + "; no spills")


def make_batches(cfg: ColvoConfig, device, n: int = TRAIN_STEPS + 1, n_frames: int = 24):
    """``n`` batches of rendered snippets at ``cfg``'s size, on ``device``."""
    t0 = time.time()
    ds = synthetic_dataset(cfg.data, n_sequences=2, n_frames=n_frames)
    it = batch_iterator(ds, cfg.data, seed=0)
    batches = [to_device(next(it), device) for _ in range(n)]
    log(f"rendered {len(ds)} snippets at {cfg.data.height}x{cfg.data.width} "
        f"in {time.time() - t0:.1f} s")
    return batches


def expected_launches(cfg: ColvoConfig, n_steps: int) -> dict:
    """The kernel launches of ``n_steps`` train steps and one held-out
    no-grad loss: per step, one photometric error per (scale, source) and
    one geo warp for all scales (one S launch, and one T in the backward)."""
    n_scales, n_sources = cfg.model.n_scales, len(cfg.data.frame_offsets)
    pairs = n_scales * n_sources
    counts = {"S/grad/C1": n_steps, "T/C1": n_steps, "S/value/C1": 1}
    if cfg.loss.fused_kernel:
        counts.update({"F/fwd/C3": pairs * (n_steps + 1), "F/bwd/C3": pairs * n_steps})
    elif cfg.loss.batched_photo:
        counts.update({f"S/grad/C3/g{n_scales}": n_steps, f"S/value/C3/g{n_scales}": 1})
    else:
        counts.update({"S/grad/C3": pairs * n_steps, "S/value/C3": pairs})
    return counts


def slice_phase(cfg: ColvoConfig, device, batches, n_steps: int = TRAIN_STEPS):
    """Train steps at ``cfg``'s size + a held-out no-grad loss on
    ``batches[n_steps]``; returns the state, the metrics by step, the
    launch counts, the median ms/step (CUDA events) and the median host
    time of a ``train_step`` call (its dispatch)."""
    state = init_state(cfg, device=device)

    # Step 1's loss, recomputed with the plain kernels on the same weights.
    with torch.no_grad(), mock.patch.object(sampler, "sample", sampler.sample_plain), \
            mock.patch.object(sampler, "sample_multi", sampler.sample_multi_plain), \
            mock.patch.object(scatter, "scatter", scatter.scatter_plain), \
            mock.patch.object(scatter, "scatter_multi", scatter.scatter_multi_plain), \
            mock.patch.object(fused_loss, "err", fused_loss.err_plain), \
            mock.patch.object(fused_loss, "err_bwd", fused_loss.err_bwd_plain):
        _, ref_aux = loss_fn(state.model, batches[0], cfg)
    ref_aux = {k: v.item() for k, v in ref_aux.items()}

    reset_launch_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              if device.type == "cuda" else None for _ in range(n_steps)]
    metrics, host_s = [], []
    for i in range(n_steps):
        if events[i]:
            events[i][0].record()
        t0 = time.perf_counter()
        metrics.append(train_step(state, batches[i], cfg))
        host_s.append(time.perf_counter() - t0)
        if events[i]:
            events[i][1].record()
    with torch.no_grad():
        eval_loss, _ = loss_fn(state.model, batches[n_steps], cfg)
    counts = launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events] if device.type == "cuda" else []

    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        log(f"step {i + 1}: " + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
        check(all(np.isfinite(v) for v in m.values()), f"finite metrics at step {i + 1}")
    check(np.isfinite(eval_loss.item()), "finite held-out loss")
    for k, v in ref_aux.items():
        got = metrics[0][k]
        check(abs(got - v) <= 1e-3 * max(abs(v), 1e-6), f"step 1 {k}: kernels {got} vs plain {v}")
    log("step 1 vs plain kernels: " + " ".join(
        f"{k} {metrics[0][k]:.6g}/{v:.6g}" for k, v in ref_aux.items()))
    log(f"held-out loss (no grad): {eval_loss.item():.6g}; launches: {counts}")
    med, host_med = float("nan"), 1e3 * float(np.median(host_s[1:]))
    if device.type == "cuda":
        busy = profile_step(state, batches[0], cfg)
        med = float(np.median(step_ms[1:]))
        log(f"train step: {med:.2f} ms/step (median of steps 2..{n_steps}, CUDA events; "
            f"all: {[round(t, 2) for t in step_ms]}); device busy {busy:.2f} ms of it "
            f"({100 * busy / med:.1f} %, kernel time of the profiled step); a train_step call "
            f"returns after {host_med:.2f} ms on the host clock (median, its dispatch)")
    return state, metrics, counts, med, host_med


# Kernel-name keywords of the buckets in the step breakdown, first match wins.
BUCKETS = (
    ("S (bilinear_sample)", ("bilinear_sample",)),
    ("F (fused_err)", ("fused_err",)),
    ("T (bilinear_scatter)", ("bilinear_scatter",)),
    ("conv / gemm", ("conv", "gemm", "xmma", "cutlass", "sm90", "wgrad", "dgrad", "fprop")),
    ("norm", ("norm",)),
    ("pooling", ("pool",)),
    ("reduce", ("reduce",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / fill", ("copy", "memcpy", "memset", "fill", "cat")),
)


def profile_step(state, batch, cfg: ColvoConfig) -> float:
    """One more train step under ``torch.profiler``: device time by kernel,
    by bucket and by ATen op and input shapes, the device's busy share of
    the step, peak memory. Returns the device's kernel time in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        train_step(state, batch, cfg)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(os.path.join(tmp, "step.json"))
        log("profiled step, the host: " + trace_host(os.path.join(tmp, "step.json")))
    kernels = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total / 1e3
    busy = sum(kernels.values())
    log(f"profiled step: {step_ms:.2f} ms (CUDA events), peak memory {peak_gib:.2f} GiB")
    if busy == 0.0:
        log("profiled step: the profiler recorded no device time; breakdown not measured")
        return busy
    log(f"profiled step: device busy {busy:.2f} ms = {100 * busy / step_ms:.1f} % of the "
        f"profiled step, {len(kernels)} kernels by name")
    buckets = {}
    for name, ms in kernels.items():
        low = name.lower()
        bucket = next((b for b, keys in BUCKETS if any(k in low for k in keys)), "other")
        buckets[bucket] = buckets.get(bucket, 0.0) + ms
    for bucket, ms in sorted(buckets.items(), key=lambda kv: -kv[1]):
        log(f"  bucket {bucket:26s} {ms:8.3f} ms  {100 * ms / busy:5.1f} %")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  kernel {ms:8.3f} ms  {100 * ms / busy:5.1f} %  {name[:110]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3
        log(f"  op {ms:8.3f} ms  {100 * ms / busy:5.1f} %  x{e.count} {e.key} "
            f"{str(e.input_shapes)[:90]}")
    return busy


def serving_phase(cfg: ColvoConfig, state, device, pairs: int = 4, iters: int = 10):
    """Coupled depth+pose on frame pairs; returns pairs/s."""
    from colvo_torch.data import render_sequence

    seq = render_sequence(n_frames=pairs + 1, height=cfg.data.height, width=cfg.data.width)
    runner = InferenceRunner(cfg, state.model.state_dict(), device=device)
    a, b = seq.frames[:-1], seq.frames[1:]
    out = runner.infer_coupled(a, b)
    shapes = [o.shape for o in out]
    check(shapes == [(pairs, cfg.data.height, cfg.data.width)] * 2 + [(pairs, 3)] * 2,
          f"infer_coupled shapes {shapes}")
    check(all(np.isfinite(o).all() for o in out), "infer_coupled finite")
    t0 = time.time()
    for _ in range(iters):
        runner.infer_coupled(a, b)
    rate = pairs * iters / (time.time() - t0)
    log(f"infer_coupled: {rate:.1f} pairs/s ({pairs} pairs a call, host clock, "
        f"numpy in and out)")
    return rate


VO_FRAMES, VO_CHUNK, VO_SEED = 64, 16, 999  # evaluate_synthetic renders its sequence at seed 999
VO_MIN_FPS = 30.0  # the coupled-serving north star (PERF.md §2)
VO_RUNS = 3  # timed run_vo calls after one warm-up; the median is reported
# The float32-wire stream against per-pair infer_coupled on the card: bf16
# convs at batch 16 against batch 2 may take other cuDNN algorithms, whose
# float32 sums round to bf16 differently, and the differences carry through
# the network. Relative depth error, and rel6 error over max|rel6|; on the
# H100 with 6-step weights they measured 1.5e-2 and 7.2e-4. The same bound
# holds symmetric pose's translation (a batch of 2W pairs) to the forward
# reading's (measured 4.6e-4).
TOL_VO_DEPTH_REL, TOL_VO_REL6 = 5e-2, 5e-3
TOL_F16_REL = 2.0**-11  # half a float16 ulp, relative
# i420 against rgb: 4:2:0 chroma subsampling changes the input (the
# reference's own test of the two: poses 2e-2 abs, depths 0.1 rel + 2e-2)
TOL_I420_POSE, TOL_I420_DEPTH = 2e-2, (0.1, 2e-2)
VO_MODES = (("rgb", "float16"), ("rgb", "uint8"), ("i420", "float16"), ("i420", "uint8"))


def _median_fps(fn, n_frames: int) -> float:
    """Frames/s of ``fn()`` on the host clock: one warm-up call, then the
    median of ``VO_RUNS`` calls."""
    fn()
    times = []
    for _ in range(VO_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return n_frames / float(np.median(times))


def vo_phase(cfg: ColvoConfig, state, device, smi: str, timed: bool = True) -> dict:
    """Streaming VO on the trained weights at ``cfg``'s size: run_vo over a
    rendered sequence, its checks against per-pair serving, across wires
    and input formats and with symmetric pose, the evaluation on top
    (ATE/RPE, polyps, stitched cloud, PLY), and its times. No kernel of
    the training path may launch. Returns frames/s by mode (none unless
    ``timed``, which needs a CUDA device)."""
    from colvo_torch.data import render_sequence
    from colvo_torch.evaluation import evaluate_pose
    from colvo_torch.vo import (PolypDetection, StreamingVO, VOResult, load_ply,
                                localize_polyps, run_vo, save_ply, stitch_pointclouds, umeyama)
    from colvo_torch.vo.driver import chain_relative_poses, chain_relative_poses_np
    from colvo_torch.vo.stream import rgb_to_i420

    h, w = cfg.data.height, cfg.data.width
    t_phase = t0 = time.time()
    seq = render_sequence(n_frames=VO_FRAMES, height=h, width=w, seed=VO_SEED)
    u8 = np.clip(seq.frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    inputs = {"rgb": list(u8), "i420": list(rgb_to_i420(u8))}
    log(f"VO: rendered {VO_FRAMES} frames at {h}x{w} in {time.time() - t0:.1f} s")
    runner = InferenceRunner(cfg, state.model.state_dict(), device=device)
    stream = lambda fmt="rgb", wire="float32", **kw: StreamingVO(  # noqa: E731
        runner, chunk_size=VO_CHUNK, depth_dtype=wire, input_format=fmt, **kw).run(inputs[fmt])
    reset_launch_counts()

    vo = run_vo(runner, inputs["rgb"], keyframe_every=1, chunk_size=VO_CHUNK)
    rot = vo.poses[:, :3, :3]
    check(vo.poses.shape == (VO_FRAMES, 4, 4) and vo.poses.dtype == np.float64, "VO poses shape")
    check(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max() <= 1e-9, "VO rotations orthonormal")
    check(len(vo.depths) == VO_FRAMES and all(d.shape == (h, w) and np.isfinite(d).all()
                                              for d in vo.depths), "VO depths finite")

    # The float32 wire against per-pair serving (batch 2, the same /255).
    d32, p32 = stream()
    f32 = [f.astype(np.float32) / 255.0 for f in inputs["rgb"]]
    pairs = [runner.infer_coupled(a[None], b[None]) for a, b in zip(f32[:-1], f32[1:])]
    want_d = np.stack([p[0][0] for p in pairs] + [pairs[-1][1][0]])
    want_p = np.stack([np.concatenate([p[2][0], p[3][0]]) for p in pairs])
    err_d = float(np.abs(np.stack(d32) / want_d - 1).max())
    err_p = float(np.abs(p32 - want_p).max() / np.abs(want_p).max())
    log(f"VO f32 wire vs per-pair infer_coupled: depth max rel {err_d:.3g}, "
        f"rel6 max abs / max|rel6| {err_p:.3g} (max|rel6| {np.abs(want_p).max():.3g})")
    check(err_d <= TOL_VO_DEPTH_REL and err_p <= TOL_VO_REL6, "VO stream vs per-pair serving")

    for wire in ("float16", "uint8"):
        d, p = stream(wire=wire)
        check(np.array_equal(p, p32), f"VO poses equal on the {wire} and float32 wires")
        if wire == "float16":
            err = max(float(np.abs(a / b - 1).max()) for a, b in zip(d, d32))
            check(err <= TOL_F16_REL, f"VO f16 wire within {TOL_F16_REL:.3g} rel")
        else:
            err = 0.0
            for a, b in zip(d, d32):  # in disparity, in steps of 1/255 of the frame's span,
                # less the float32 rounding of decoding lo + q·step
                step = ((1 / b).max() - (1 / b).min()) / 255.0
                dev = np.abs(1 / a - 1 / b).max() - 4 * np.spacing((1 / b).max())
                err = max(err, float(dev / step))
            # (1e-3 of a step: the float32 rounding of the device's division)
            check(err <= 0.5 + 1e-3, "VO uint8 wire within half a quantisation step")
        log(f"VO {wire} wire vs float32: max error {err:.3g} "
            f"({'relative depth' if wire == 'float16' else 'disparity steps'}); poses equal")
    d_y, p_y = stream("i420")
    err_py = float(np.abs(p_y - p32).max())
    err_dy = max(float((np.abs(a - b) - TOL_I420_DEPTH[0] * np.abs(b)).max()) for a, b in zip(d_y, d32))
    log(f"VO i420 vs rgb: rel6 max abs {err_py:.3g}, depth max |Δ| − 0.1·|d| {err_dy:.3g}")
    check(err_py <= TOL_I420_POSE and err_dy <= TOL_I420_DEPTH[1], "VO i420 close to rgb")
    _, p_sym = stream(symmetric_pose=True)
    err_t = float(np.abs(p_sym[:, 3:] - p32[:, 3:]).max() / np.abs(p32[:, 3:]).max())
    err_r = float(np.abs(p_sym[:, :3] - p32[:, :3]).max())
    log(f"VO symmetric pose: translation vs forward reading max abs / max|t| {err_t:.3g}; "
        f"rotation moved by up to {err_r:.3g}")
    check(err_t <= TOL_VO_REL6, "VO symmetric pose keeps the forward translation")
    err_chain = float(np.abs(chain_relative_poses(p32) - chain_relative_poses_np(p32)).max())
    check(err_chain <= 1e-12, f"native chain vs numpy chain {err_chain:.3g}")

    # evaluate_synthetic's pose, polyp and reconstruction steps.
    metrics = evaluate_pose(vo.poses, seq.poses.astype(np.float64))
    rng = np.random.default_rng(5)
    k_inv = np.linalg.inv(seq.k.astype(np.float64))
    dets, gts = [], []
    for fid in (VO_FRAMES // 4, VO_FRAMES // 2, 3 * VO_FRAMES // 4):
        cx, cy = int(rng.integers(w // 4, 3 * w // 4)), int(rng.integers(h // 4, 3 * h // 4))
        dets.append(PolypDetection(frame_id=fid, box=(cx - 6, cy - 6, cx + 6, cy + 6)))
        pose = seq.poses[fid].astype(np.float64)
        gts.append(pose[:3, :3] @ (k_inv @ np.array([cx, cy, 1.0]) * seq.depths[fid][cy, cx])
                   + pose[:3, 3])
    r, t, s = umeyama(vo.poses[:, :3, 3], seq.poses[:, :3, 3])
    apose = vo.poses.copy()
    apose[:, :3, 3] = (s * (r @ vo.poses[:, :3, 3].T)).T + t
    apose[:, :3, :3] = r @ vo.poses[:, :3, :3]
    aligned = VOResult(poses=apose, depths=[d * s for d in vo.depths], keyframe_ids=vo.keyframe_ids)
    errs = [loc.error for loc in localize_polyps(aligned, seq.k, dets, np.stack(gts))]
    metrics.update({f"polyp/e{i + 1}": e for i, e in enumerate(errs)})
    metrics["polyp/e_mean"] = float(np.mean(errs))
    t0 = time.perf_counter()
    cloud = stitch_pointclouds(vo, seq.k, frames=inputs["rgb"], voxel=0.002,
                               max_depth=cfg.model.max_depth)
    stitch_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        save_ply(cloud, os.path.join(tmp, "cloud.ply"))
        n_back = len(load_ply(os.path.join(tmp, "cloud.ply")))
    check(all(np.isfinite(v) for v in metrics.values()), f"VO metrics finite: {metrics}")
    check(len(cloud) > 0 and np.isfinite(cloud.points).all() and n_back == len(cloud),
          "VO cloud non-empty, finite, PLY round trip")
    log("VO evaluation (6-step weights: finite, not accurate): " + " ".join(
        f"{k}={v:.5g}" for k, v in metrics.items())
        + f"; cloud {len(cloud)} points at voxel 0.002 (stitch {1e3 * stitch_s:.1f} ms)")
    counts = launch_counts()
    check(counts == {}, f"the VO path launched training kernels: {counts}")

    if not timed:
        return {}
    # Times (host clock for frames/s; the card's name and limit beside them).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the training state and the runner's weights
    fps = {"run_vo rgb/float16": _median_fps(
        lambda: run_vo(runner, inputs["rgb"], keyframe_every=1, chunk_size=VO_CHUNK), VO_FRAMES)}
    peak, held = torch.cuda.max_memory_allocated() / 2**30, held / 2**30
    for fmt, wire in VO_MODES:
        fps[f"stream {fmt}/{wire}"] = _median_fps(lambda: stream(fmt, wire), VO_FRAMES)
    fps["stream rgb/float16 symmetric"] = _median_fps(
        lambda: stream("rgb", "float16", symmetric_pose=True), VO_FRAMES)
    log(f"VO frames/s ({VO_FRAMES} frames at {h}x{w}, chunks of {VO_CHUNK}, host clock, median "
        f"of {VO_RUNS} after a warm-up; {smi}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in fps.items()))
    check(min(fps.values()) >= VO_MIN_FPS, f"VO frames/s under {VO_MIN_FPS}: {fps}")
    vo_stage_times(runner, inputs["rgb"], p32, smi)
    vo_busy(lambda: run_vo(runner, inputs["rgb"], keyframe_every=1, chunk_size=VO_CHUNK), smi)
    log(f"VO peak device memory over run_vo: {peak:.3f} GiB, {peak - held:.3f} GiB above the "
        f"{held:.3f} GiB held before it; the VO phase took {time.time() - t_phase:.1f} s")
    return fps


def vo_stage_times(runner, frames, rel6, smi: str) -> None:
    """The layers of one chunk (rgb uint8 in, float16 wire out): H2D from
    pinned memory, the chunk step (eager, and as CUDA-graph replays), D2H
    of the wire into pinned memory (CUDA events), the host decode and the
    native chain of the whole sequence (host clock)."""
    from colvo_torch.vo import StreamingVO, chain_relative_poses

    sv = StreamingVO(runner, chunk_size=VO_CHUNK)
    hw = frames[0].shape[:2]
    pinned = torch.from_numpy(np.stack(frames[1:1 + VO_CHUNK])).pin_memory()
    with torch.inference_mode():
        _, ci, cb = sv.init_step(torch.from_numpy(frames[0][None]).cuda())
        dev = pinned.cuda()
        wire = sv.chunk_step(ci, cb, dev)[0]
        out = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        h2d = eager_ms(lambda: pinned.to("cuda", non_blocking=True))
        step_eager = eager_ms(lambda: sv.chunk_step(ci, cb, dev))
        step_graph = time_ms(lambda: sv.chunk_step(ci, cb, dev))
        d2h = eager_ms(lambda: out.copy_(wire, non_blocking=True))
    torch.cuda.synchronize()
    buf = out.numpy()
    t0 = time.perf_counter()
    for _ in range(20):
        sv.decode_wire(buf, hw)
    decode = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        chain_relative_poses(rel6)
    chain = (time.perf_counter() - t0) / 20 * 1e3
    log(f"VO layers, one chunk of {VO_CHUNK} ({smi}): H2D {h2d:.4f} ms ({pinned.numel() / 2**20:.2f} "
        f"MiB, CUDA events); chunk step {step_eager:.3f} ms eager, {step_graph:.3f} ms on the "
        f"device (CUDA-graph replays); D2H {d2h:.4f} ms ({wire.numel() / 2**20:.2f} MiB wire); "
        f"host decode {decode:.3f} ms; native chain of {len(rel6)} poses {chain:.3f} ms (host clock)")


def busy_share(fn) -> tuple:
    """(device ms, host ms, kernels by name) of one ``fn()`` after a warm-up
    call: the device time of kernels and copies under ``torch.profiler``
    and the host clock of the call, which ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total / 1e3
    return sum(kernels.values()), wall, kernels


def vo_busy(fn, smi: str) -> None:
    """The card's busy share over one ``fn()``."""
    busy, wall, kernels = busy_share(fn)
    if busy == 0.0:
        log("VO busy share: the profiler recorded no device time; not measured")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"VO busy share over one run_vo ({smi}): device {busy:.2f} ms of {wall:.2f} ms "
        f"({100 * busy / wall:.1f} %, profiled); top: "
        + "; ".join(f"{ms:.2f} ms {name[:60]}" for name, ms in top))


LOOP_STEPS, LOOP_RESUME_TO = 8, 10  # run 1 of the CLI, then run 2 resumes to this step
LOOP_ARGS = ["--train.log_every=2", "--train.ckpt_every_steps=4"]
LOOP_PROFILE = (5, 7)  # train.profile_steps of run 1
LOOP_SMALL = (64, 96)  # the NaN-stop and restart runs' frames
LOOP_ALONE_BATCHES = 5  # batches the producer's code builds alone, timed


def _png_shape(path: str) -> tuple:
    """Decode an 8-bit RGB PNG with zlib alone; returns its array's shape."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = body
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    check(hdr[8:10] == b"\x08\x02", f"{path}: 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3).shape


def trace_busy(path: str) -> tuple:
    """(device-busy ms, window ms) of a ``torch.profiler`` Chrome trace: the
    union of its kernel, copy and memset intervals, over the span of all
    its events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -float("inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / 1e3, span / 1e3


def trace_host(path: str, top: int = 6) -> str:
    """The host side of a ``torch.profiler`` Chrome trace: the CUDA runtime
    and driver calls with the most time summed over the window (a call
    that blocks, a synchronize or an allocation shows here), then the
    outermost ATen ops of each thread by summed time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls, n_calls, outer = Counter(), Counter(), Counter()
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls[e["name"]] += e["dur"] / 1e3
            n_calls[e["name"]] += 1
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("tid"), e["ts"]))
    end, tid = -float("inf"), None
    for e in ops:
        if e.get("tid") != tid or e["ts"] >= end:
            outer[e["name"]] += e["dur"] / 1e3
            end, tid = e["ts"] + e["dur"], e.get("tid")
    return ("runtime calls " + "; ".join(f"{k} {v:.2f} ms x{n_calls[k]}"
                                         for k, v in calls.most_common(top))
            + " | outermost ops " + "; ".join(f"{k[:48]} {v:.2f} ms"
                                              for k, v in outer.most_common(top)))


def _timed_batches(real, times):
    """``batch_iterator`` whose every ``next`` is timed on the host clock
    (in the prefetcher's producer thread, so GIL waits are in the time)."""
    def wrapped(*args, **kwargs):
        it = real(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            times.append(time.perf_counter() - t0)
            yield batch
    return wrapped


def loop_phase(device, smi: str, slice_ms: float, slice_dispatch_ms: float) -> dict:
    """The training entry point at full width, in process through the CLI:
    run 1 trains ``LOOP_STEPS`` steps on the synthetic dataset (logging
    every 2, checkpoints every 4, the profiler over ``LOOP_PROFILE``, the
    eval hook at the epoch's end, step 7), ``export`` writes the weights,
    run 2 resumes to ``LOOP_RESUME_TO``. The producer thread's batch time
    and each ``train_step`` call's host time are taken during run 1, and
    the producer's again alone on run 1's dataset. Then the dispatch-side
    NaN stop and a basin restart at ``LOOP_SMALL``. Returns run 1's kernel
    launches, its dataset and its ms/step."""
    import contextlib
    import io

    from colvo_torch import cli, pipelines
    from colvo_torch.runtime import CheckpointManager, params_from_flax
    from colvo_torch.runtime import loop as loop_mod

    t_phase = time.time()
    cfg = ColvoConfig()
    runs, datasets, producer_s, calls = [], [], [], []
    real_train, real_step = pipelines.train_loop, loop_mod.train_step

    def recording(cfg_, dataset, **kwargs):
        datasets.append(dataset)
        out = real_train(cfg_, dataset, **kwargs)
        runs.append(out[1])
        return out

    def timed_step(*args):
        t0 = time.perf_counter()
        out = real_step(*args)
        calls.append((t0, time.perf_counter()))
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(pipelines, "train_loop", recording):
        log_dir, ckpt_dir = os.path.join(tmp, "log"), os.path.join(tmp, "ckpt")
        common = LOOP_ARGS + ["--log-dir", log_dir, f"--train.ckpt_dir={ckpt_dir}",
                              "--device", device.type]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        with mock.patch.object(loop_mod, "batch_iterator",
                               _timed_batches(loop_mod.batch_iterator, producer_s)), \
                mock.patch.object(loop_mod, "train_step", timed_step):
            check(cli.main(["train", "--max-steps", str(LOOP_STEPS),
                            "--train.profile_steps={}:{}".format(*LOOP_PROFILE)] + common) == 0,
                  "cli train, run 1")
        run1_s = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = Counter(expected_launches(cfg, LOOP_STEPS)) - Counter(expected_launches(cfg, 0))
        check(counts == dict(per_step), f"loop run 1 launches {counts} == {dict(per_step)}")

        # The checkpoint of step 8 holds run 1's final state bit for bit.
        state = runs[0]
        check(state.step == LOOP_STEPS, f"run 1 ended at step {state.step}")
        check(sorted(int(d) for d in os.listdir(ckpt_dir)) == [4, 8], "checkpoints at 4 and 8")
        payload, _, _ = CheckpointManager(ckpt_dir).load(LOOP_STEPS)
        live = {f"model/{k}": v for k, v in state.model.state_dict().items()}
        saved = {f"model/{k}": v for k, v in payload["model"].items()}
        for i, s in state.optimizer.state_dict()["state"].items():
            live.update({f"adam/{i}/{k}": v for k, v in s.items()})
            saved.update({f"adam/{i}/{k}": v for k, v in payload["optimizer"]["state"][i].items()})
        check(live.keys() == saved.keys() and all(
            torch.equal(live[k].cpu(), saved[k]) for k in live),
            "the step-8 checkpoint equals run 1's state bit for bit (model, Adam moments)")
        out = os.path.join(tmp, "weights.npz")
        check(cli.main(["export", ckpt_dir, out]) == 0, "cli export")
        with np.load(out) as f:
            exported = params_from_flax({k: f[k] for k in f.files}, cfg.model)
        model_sd = state.model.state_dict()
        check(all(torch.equal(v, model_sd[k].cpu()) for k, v in exported.items()),
              "the export maps back onto the model, no key left over, bit for bit")
        del state, payload, live, saved, model_sd
        runs.clear()
        it = batch_iterator(datasets[0], cfg.data, seed=cfg.train.seed)
        alone_s = []
        for _ in range(LOOP_ALONE_BATCHES):
            t0 = time.perf_counter()
            next(it)
            alone_s.append(time.perf_counter() - t0)

        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            check(cli.main(["train", "--resume", "--max-steps", str(LOOP_RESUME_TO)] + common)
                  == 0, "cli train --resume, run 2")
        run2_s = time.time() - t0
        log(buf.getvalue().rstrip())
        check(f"resumed from step {LOOP_STEPS}" in buf.getvalue() and runs[0].step == LOOP_RESUME_TO,
              "run 2 resumed at step 8 and ended at 10")
        runs.clear()

        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r for r in rows if "loss/total" in r]
        evals = [r for r in rows if "eval/abs_rel" in r]
        walls = [r for r in rows if "wall_steps_per_sec" in r]
        check([r["step"] for r in losses] == [2, 4, 6, 8, 10], f"loss rows {losses}")
        check(all(np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")),
              "every logged loss finite")
        check([r["step"] for r in evals] == [7] and "eval/ate" in evals[0]
              and all(np.isfinite(v) for v in evals[0].values()), f"eval rows {evals}")
        check([r["step"] for r in walls] == [8, 10], f"wall rows {walls}")
        for tag in ("disp", "automask", "warp_error"):
            shape = _png_shape(os.path.join(log_dir, f"panels_{tag}_00000007.png"))
            check(shape == (cfg.data.height, cfg.data.width, 3), f"panel {tag} {shape}")
        trace = os.path.join(log_dir, "trace_steps_{}_{}.json".format(*LOOP_PROFILE))
        busy, window = trace_busy(trace)
        host = trace_host(trace)
    sps = [round(r["steps_per_sec"], 3) for r in rows if "steps_per_sec" in r]
    log(f"eval hook at step 7: " + " ".join(
        f"{k}={v:.5g}" for k, v in evals[0].items() if k.startswith("eval/")))
    loop_ms = 1e3 / walls[0]["wall_steps_per_sec"]
    log(f"loop ({smi}): run 1 {loop_ms:.2f} ms/step over {LOOP_STEPS} steps (wall_steps_per_sec, "
        f"eval hook, profiler window and checkpoints included) against the default slice's "
        f"{slice_ms:.2f} ms/step (median, CUDA events, same process): {loop_ms - slice_ms:+.2f} ms; "
        f"run 2 {1e3 / walls[1]['wall_steps_per_sec']:.2f} ms/step over "
        f"{LOOP_RESUME_TO - LOOP_STEPS} steps; the logger's stamped steps/s {sps}")
    log(f"loop: the card busy {busy:.2f} ms of the {window:.2f} ms profiled window (steps "
        "{}-{}, {:.1f} %); peak memory over run 1 {:.2f} GiB; run 1 took {:.1f} s, run 2 {:.1f} s "
        "(rendering, init, steps)".format(*LOOP_PROFILE, 100 * busy / window, peak, run1_s, run2_s))
    log(f"loop: the producer thread built a batch (B={cfg.data.batch_size}, augment) in "
        f"{1e3 * np.median(producer_s):.1f} ms (median of {len(producer_s)}, host clock, "
        f"while training; all {[round(1e3 * t, 1) for t in producer_s]}), and "
        f"{1e3 * np.median(alone_s):.1f} ms alone (median of {len(alone_s)}, the main thread, "
        f"nothing else running; all {[round(1e3 * t, 1) for t in alone_s]})")
    dispatch = [1e3 * (b - a) for a, b in calls]
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(calls, calls[1:])]
    log(f"loop: a train_step call returned after {np.median(dispatch[1:]):.2f} ms on the host "
        f"clock in run 1 (median of steps 2-{LOOP_STEPS}; the slice's {slice_dispatch_ms:.2f}); "
        f"one call started every {np.median(gaps):.2f} ms (median; all "
        f"{[round(g, 1) for g in gaps]}; the eval hook runs between steps 7 and 8)")
    log("loop: the host over the profiled window: " + host)
    loop_small_runs(device)
    log(f"the loop phase took {time.time() - t_phase:.1f} s")
    return counts, datasets[0], loop_ms


def loop_small_runs(device) -> None:
    """The dispatch-side NaN stop and a basin restart, at ``LOOP_SMALL``."""
    from colvo_torch.data import SnippetDataset, render_sequence
    from colvo_torch.runtime import loop as loop_mod

    h, w = LOOP_SMALL
    seq = render_sequence(n_frames=16, height=h, width=w, seed=3)
    poisoned = seq.frames.copy()
    poisoned[2] = np.nan
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ColvoConfig()
        cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 4
        cfg.train.log_every, cfg.train.dispatch_ahead_windows = 1, 1
        cfg.train.ckpt_dir = os.path.join(tmp, "nan_ckpt")
        calls = []
        real_step = loop_mod.train_step

        def counted(state, batch, cfg_):
            calls.append(state.step + 1)
            return real_step(state, batch, cfg_)

        ds = SnippetDataset([poisoned], [seq.k], cfg.data.frame_offsets)
        raised = None
        try:
            with mock.patch.object(loop_mod, "train_step", counted):
                loop_mod.train(cfg, ds, log_dir=os.path.join(tmp, "nan_log"), max_steps=30,
                               device=device)
        except RuntimeError as e:
            raised = str(e)
        check(raised is not None and "non-finite loss at step" in raised,
              f"the poisoned run raised the dispatch-side stop: {raised}")
        bad = int(raised.rsplit(" ", 1)[-1])
        windows = cfg.train.dispatch_ahead_windows + 1
        check(calls[-1] - bad <= windows * cfg.train.log_every,
              f"NaN stop within {windows} log windows: step {bad} retired at {calls[-1]}")
        log(f"loop NaN stop at {h}x{w}: non-finite loss of step {bad} raised after "
            f"{calls[-1]} dispatched steps")

        cfg = ColvoConfig()
        cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 4
        cfg.train.log_every = cfg.train.ckpt_every_steps = 2
        cfg.train.ckpt_dir = os.path.join(tmp, "restart_ckpt")
        cfg.train.restart_metric, cfg.train.restart_threshold = "loss/total", 1e-9
        cfg.train.restart_check_step, cfg.train.restart_max = 3, 1
        ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
        _, state = loop_mod.train(cfg, ds, log_dir=os.path.join(tmp, "restart_log"),
                                  max_steps=6, device=device)
        with open(os.path.join(tmp, "restart_log", "metrics.jsonl")) as f:
            restarts = [json.loads(line) for line in f if "restart/attempt" in line]
        check(len(restarts) == 1 and restarts[0]["restart/new_seed"] == cfg.train.seed + 1000
              and state.step == 6, f"one restart, then 6 steps: {restarts}, step {state.step}")
        log(f"loop restart at {h}x{w}: fired once at step {restarts[0]['step']} "
            f"(loss/total {restarts[0]['restart/metric_value']:.4g}), ended at step {state.step}")


STORE_SHAPE = (100, 100)  # sequences × frames: the corpus colvo/data/device_store.py:5-7 sizes
CHUNK_K, CHUNK_REPLAYS, CHUNK_TIMED = 4, 3, 5  # steps a chunk; checked and timed replays
TOL_CHUNK_REL = 1e-3  # step 1's loss terms, chunk against eager (the slice's path check)


def device_loader_phase(device, smi: str, dataset, numpy_loop_ms: float, slice_ms: float,
                        slice_dispatch_ms: float) -> Counter:
    """The device-resident corpus and the captured chunk at full width: run
    3 of ``cli train`` on ``data.loader=device`` (``device_loop_run``); a
    store of ``STORE_SHAPE`` frames (``store_times``); ``make_scan_train``
    at ``CHUNK_K`` against eager steps on the same draws (``chunk_check``).
    Returns the launches of run 3 and of the checked replays."""
    t_phase = time.time()
    counts = Counter(device_loop_run(device, smi, dataset, numpy_loop_ms, slice_dispatch_ms))
    store_times(device, smi, dataset)
    counts.update(chunk_check(device, smi, dataset, slice_ms))
    log(f"the device-loader phase took {time.time() - t_phase:.1f} s")
    return counts


def device_loop_run(device, smi: str, dataset, numpy_loop_ms: float,
                    slice_dispatch_ms: float) -> dict:
    """``cli train --data.loader=device`` in process on the loop phase's
    dataset, as run 1 (``LOOP_STEPS`` steps, metrics every 2, checkpoints
    every 4, the profiler over ``LOOP_PROFILE``, the eval hook at step 7):
    its rows, panels, checkpoints and launches checked; loop ms/step beside
    run 1's, the interval between ``train_step`` calls, the card's busy
    share over the profiled window, peak memory and the store's upload.
    Returns its launches."""
    from colvo_torch import cli, pipelines
    from colvo_torch.runtime import loop as loop_mod

    cfg = ColvoConfig()
    runs, calls, uploads = [], [], []
    real_train, real_step, real_store = (pipelines.train_loop, loop_mod.train_step,
                                         loop_mod.DeviceSnippetStore)

    def recording(cfg_, dataset_, **kwargs):
        out = real_train(cfg_, dataset_, **kwargs)
        runs.append(out[1])
        return out

    def timed_step(*args):
        t0 = time.perf_counter()
        out = real_step(*args)
        calls.append((t0, time.perf_counter()))
        return out

    def timed_store(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store = real_store(*args, **kwargs)
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t0, store.frames.numel()))
        return store

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(pipelines, "build_dataset", lambda cfg_: dataset), \
            mock.patch.object(pipelines, "train_loop", recording), \
            mock.patch.object(loop_mod, "train_step", timed_step), \
            mock.patch.object(loop_mod, "DeviceSnippetStore", timed_store):
        log_dir, ckpt_dir = os.path.join(tmp, "log"), os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.time()
        check(cli.main(["train", "--max-steps", str(LOOP_STEPS), "--data.loader=device",
                        "--train.profile_steps={}:{}".format(*LOOP_PROFILE)] + LOOP_ARGS
                       + ["--log-dir", log_dir, f"--train.ckpt_dir={ckpt_dir}",
                          "--device", device.type]) == 0, "cli train --data.loader=device")
        run_s = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = Counter(expected_launches(cfg, LOOP_STEPS)) - Counter(expected_launches(cfg, 0))
        check(counts == dict(per_step), f"device-loader run launches {counts} == {dict(per_step)}")
        check(runs[0].step == LOOP_STEPS, f"the device-loader run ended at step {runs[0].step}")
        check(sorted(int(d) for d in os.listdir(ckpt_dir)) == [4, 8], "checkpoints at 4 and 8")
        runs.clear()
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r for r in rows if "loss/total" in r]
        evals = [r for r in rows if "eval/abs_rel" in r]
        walls = [r for r in rows if "wall_steps_per_sec" in r]
        check([r["step"] for r in losses] == [2, 4, 6, 8], f"device-loader loss rows {losses}")
        check(all(np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")),
              "every logged loss finite (device loader)")
        check([r["step"] for r in evals] == [7] and "eval/ate" in evals[0]
              and all(np.isfinite(v) for v in evals[0].values()), f"eval rows {evals}")
        check([r["step"] for r in walls] == [8], f"wall rows {walls}")
        for tag in ("disp", "automask", "warp_error"):
            shape = _png_shape(os.path.join(log_dir, f"panels_{tag}_00000007.png"))
            check(shape == (cfg.data.height, cfg.data.width, 3), f"panel {tag} {shape}")
        trace = os.path.join(log_dir, "trace_steps_{}_{}.json".format(*LOOP_PROFILE))
        busy, window = trace_busy(trace)
        host = trace_host(trace)
    loop_ms = 1e3 / walls[0]["wall_steps_per_sec"]
    (upload_s, n_bytes), = uploads
    dispatch = [1e3 * (b - a) for a, b in calls]
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(calls, calls[1:])]
    log(f"device loader ({smi}): {loop_ms:.2f} ms/step over {LOOP_STEPS} steps "
        f"(wall_steps_per_sec, eval hook, profiler window and checkpoints included) against "
        f"the numpy loader's run 1 {numpy_loop_ms:.2f} ms/step in the same process; the store "
        f"took {1e3 * upload_s:.1f} ms to build and upload {n_bytes / 1e6:.1f} MB of uint8 "
        f"frames; the run took {run_s:.1f} s")
    log(f"device loader: one train_step call started every {np.median(gaps):.2f} ms (median; "
        f"all {[round(g, 1) for g in gaps]}), a call returned after {np.median(dispatch[1:]):.2f} "
        f"ms on the host clock (median of steps 2-{LOOP_STEPS}; the slice's "
        f"{slice_dispatch_ms:.2f}); the card busy {busy:.2f} ms of the {window:.2f} ms profiled "
        "window (steps {}-{}, {:.1f} %); peak memory {:.2f} GiB".format(
            *LOOP_PROFILE, 100 * busy / window, peak))
    log("device loader: the host over the profiled window: " + host)
    return counts


def store_times(device, smi: str, dataset) -> None:
    """A store of ``STORE_SHAPE`` frames at the dataset's size, tiled from
    its frames (content does not matter here): the upload, one batch's
    gather + augment (eager by CUDA events; on the device by CUDA-graph
    replays, with the default generator, which a capture registers), and
    the device memory the store holds."""
    from colvo_torch.data import DeviceSnippetStore, device_augment
    from colvo_torch.data.device_store import gather

    cfg = ColvoConfig()
    n_seq, n_frames = STORE_SHAPE
    base = (np.clip(np.concatenate(dataset.sequences), 0, 1) * 255).round().astype(np.uint8)
    sequences = [base[np.arange(i * n_frames, (i + 1) * n_frames) % len(base)]
                 for i in range(n_seq)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store = DeviceSnippetStore(sequences, [dataset.intrinsics[0]] * n_seq,
                               cfg.data.frame_offsets, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    store_bytes = torch.cuda.memory_allocated() - held
    flat = np.concatenate(sequences)
    del sequences
    t0 = time.perf_counter()
    copy = torch.from_numpy(flat).to(device)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del copy, flat
    gen = torch.cuda.default_generators[device.index or 0]
    idx = torch.randint(0, store.n_snippets, (cfg.data.batch_size,), device=device)
    batch = lambda: device_augment(gather(store.frames, store.table, idx), gen, cfg.data)  # noqa: E731
    aug, clean = batch()
    check(aug.shape == clean.shape == (cfg.data.batch_size, 1 + len(cfg.data.frame_offsets),
                                       cfg.data.height, cfg.data.width, 3)
          and bool(torch.isfinite(aug).all()) and 0 <= aug.min().item() <= aug.max().item() <= 1,
          "device batch shape and range")
    eager, graphed = eager_ms(batch), time_ms(batch)
    moved = aug.numel() * (1 + 4 + 4)  # uint8 read once; aug and clean written in float32
    bound_ms, _ = bound(moved, 0)
    log(f"store at {n_seq} x {n_frames} frames of {cfg.data.height}x{cfg.data.width} ({smi}): "
        f"{store.n_snippets} snippets; built and uploaded in {1e3 * build_s:.1f} ms "
        f"({store.frames.numel() / 1e9:.3f} GB of uint8; the H2D copy alone "
        f"{1e3 * h2d_s:.1f} ms, {store.frames.numel() / h2d_s / 1e9:.2f} GB/s from pageable "
        f"memory); it holds {store_bytes / 2**30:.3f} GiB of device memory")
    log(f"store: gather + augment of one batch (B={cfg.data.batch_size}) {eager:.4f} ms eager "
        f"(CUDA events), {graphed:.4f} ms on the device (CUDA-graph replays); bound "
        f"{bound_ms:.4f} ms ({moved / 1e6:.1f} MB moved at {PEAK_BYTES_S / 1e12:.2f} TB/s)")


def chunk_check(device, smi: str, dataset, slice_ms: float) -> dict:
    """``make_scan_train`` at ``CHUNK_K`` on the default path at full width,
    from the same weights and generator state as ``CHUNK_K`` eager
    ``train_step``s fed the indices and augmentation draws the chunk makes:
    the same indices, finite metrics, step 1's loss terms to
    ``TOL_CHUNK_REL``. Then ``CHUNK_REPLAYS`` replays: the counter advances
    by ``CHUNK_K`` each, each draws other indices, and the launches are
    the captured ones × replays. The chunk's ms/step (CUDA events over
    replays) beside the slice's eager step, the card's busy share over one
    replay, peak memory. Returns the checked replays' launches."""
    from colvo_torch.data import DeviceSnippetStore, device_augment
    from colvo_torch.data.device_store import gather
    from colvo_torch.runtime import make_scan_train

    cfg = ColvoConfig()
    store = DeviceSnippetStore(dataset.sequences, dataset.intrinsics, cfg.data.frame_offsets,
                               device=device)
    state, eager_state = init_state(cfg, device=device), init_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
    chunk = make_scan_train(state, cfg, CHUNK_K)
    rng = gen.get_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, first = chunk(state, store.frames, store.table, store.k, gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated()
    check(chunk.graph is not None and state.step == CHUNK_K, "the first call captured K steps")

    replay = torch.Generator(device=device)
    replay.set_state(rng)
    torch.cuda.reset_peak_memory_stats()
    before_eager = torch.cuda.memory_allocated()
    eager, drawn = [], []
    for _ in range(CHUNK_K):
        idx = torch.randint(0, store.n_snippets, (cfg.data.batch_size,), generator=replay,
                            device=device)
        aug, clean = device_augment(gather(store.frames, store.table, idx), replay, cfg.data)
        eager.append(train_step(eager_state, {"frames": aug, "frames_clean": clean,
                                              "k": store.k}, cfg))
        drawn.append(idx)
    torch.cuda.synchronize()
    eager_extra = torch.cuda.max_memory_allocated() - before_eager
    check(torch.equal(torch.stack(drawn), chunk.indices), "the chunk drew the eager steps' indices")
    got = {k: v.tolist() for k, v in first.items()}
    want = [{k: v.item() for k, v in m.items()} for m in eager]
    check(all(np.isfinite(v) for vs in got.values() for v in vs), "chunk metrics finite")
    check(all(np.isfinite(v) for m in want for v in m.values()), "eager metrics finite")
    for k, v in want[0].items():
        if k != "grad_norm":
            check(abs(got[k][0] - v) <= TOL_CHUNK_REL * max(abs(v), 1e-6),
                  f"chunk step 1 {k}: {got[k][0]} vs eager {v}")
    for i in range(CHUNK_K):
        log(f"chunk vs eager, step {i + 1}: " + " ".join(
            f"{k} {got[k][i]:.6g}/{want[i][k]:.6g}" for k in ("loss/total", "loss/photometric",
                                                              "loss/geometric", "grad_norm")))

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps, draws = [], [chunk.indices.clone()]
    for _ in range(CHUNK_REPLAYS):
        state, metrics = chunk(state, store.frames, store.table, store.k, gen)
        steps.append((state.step, chunk.step.clone()))
        draws.append(chunk.indices.clone())
    counts = launch_counts()
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated()
    check(all(host == CHUNK_K * (r + 2) and int(dev) == host for r, (host, dev) in enumerate(steps)),
          f"the step counter advanced by {CHUNK_K} a replay: {steps}")
    check(all(not torch.equal(a, b) for a, b in zip(draws, draws[1:])),
          "successive replays drew other indices")
    check(bool(torch.isfinite(metrics["loss/total"]).all()), "replayed metrics finite")
    want_counts = Counter(expected_launches(cfg, CHUNK_K * CHUNK_REPLAYS)) - Counter(
        expected_launches(cfg, 0))
    check(counts == dict(want_counts)
          and Counter({k: v * CHUNK_REPLAYS for k, v in chunk.captured_launches.items()}) == counts,
          f"replayed launches {counts} == captured {chunk.captured_launches} x {CHUNK_REPLAYS}")
    step = lambda: chunk(state, store.frames, store.table, store.k, gen)  # noqa: E731
    chunk_ms = _events_ms(step, CHUNK_TIMED) / CHUNK_K
    busy, wall, _ = busy_share(step)
    gib = lambda b: b / 2**30  # noqa: E731
    # the graph's pool holds one step's activations, not K steps'
    check(first_peak - held <= 2 * eager_extra,
          f"chunk capture peak {gib(first_peak - held):.2f} GiB over {gib(eager_extra):.2f} GiB "
          "of one eager step")
    log(f"chunk ({smi}): K={CHUNK_K}, {chunk_ms:.2f} ms/step (CUDA events over {CHUNK_TIMED} "
        f"replays) against the slice's eager {slice_ms:.2f} ms/step; the card busy {busy:.2f} ms "
        f"of one replay's {wall:.2f} ms ({100 * busy / wall:.1f} %, profiled); the first call "
        f"(warm-up, capture, one replay) took {first_s:.2f} s")
    log(f"chunk launches: captured {chunk.captured_launches} x {CHUNK_REPLAYS} replays = {counts}")
    log(f"chunk memory: {gib(held):.2f} GiB held before (two states, the store); peak "
        f"{gib(first_peak):.2f} GiB over the first call ({gib(first_peak - held):.2f} above), "
        f"{gib(replay_peak):.2f} GiB over {CHUNK_REPLAYS} replays; one eager step peaks "
        f"{gib(eager_extra):.2f} GiB above what it starts with; reserved "
        f"{gib(torch.cuda.memory_reserved()):.2f} GiB")
    return counts


KERNELS = (
    ("P1", "bilinear_sample[grad,C=3]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:658", "S/grad/C3"),
    ("P2", "bilinear_sample[value,C=3]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:664", "S/value/C3"),
    ("P3", "bilinear_sample_multi[grad,C=1,4 scales]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:700", "S/grad/C1"),
    ("P4", "bilinear_sample_multi[value,C=1,4 scales]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:706", "S/value/C1"),
    ("P5", "bilinear_scatter_multi[C=1,4 scales]", "colvo_torch/kernels/csrc/scatter.cu",
     "colvo/kernels/scatter.py:217", "T/C1"),
    ("P6", "bilinear_sample[grad,C=3,group=4]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:658", "S/grad/C3/g4"),
    ("P7", "fused_err[fwd,C=3,L=15]", "colvo_torch/kernels/csrc/fused_loss.cu",
     "colvo/kernels/fused_loss.py:275", "F/fwd/C3"),
    ("P8", "fused_err[bwd,C=3,L=15]", "colvo_torch/kernels/csrc/fused_loss.cu",
     "colvo/kernels/fused_loss.py:312", "F/bwd/C3"),
)

# The configurations the slice phase trains: the default path, and the two
# alternative photometric paths of the reference.
PATHS = (("default", {}), ("fused_kernel", {"fused_kernel": True}),
         ("batched_photo", {"batched_photo": True}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    build.build_all()
    log(f"built kernels {build.SOURCES} in {time.time() - t0:.1f} s")
    kernel_ptxas()

    rows = kernel_phase(device)
    batches = make_batches(ColvoConfig(), device)
    counts, first, step_ms, dispatch_ms = Counter(), {}, {}, {}
    for label, knobs in PATHS:
        log(f"--- slice: {label} ---")
        cfg = ColvoConfig()
        for k, v in knobs.items():
            setattr(cfg.loss, k, v)
        state, metrics, path_counts, step_ms[label], dispatch_ms[label] = slice_phase(
            cfg, device, batches)
        expect = expected_launches(cfg, TRAIN_STEPS)
        check(path_counts == expect, f"{label} launch counts {path_counts} == {expect}")
        counts.update(path_counts)
        first[label] = metrics[0]
        if label == "default":
            serving_phase(cfg, state, device)
            vo_phase(cfg, state, device, smi)
        else:
            for k, v in first["default"].items():
                check(k == "grad_norm" or abs(first[label][k] - v) <= 1e-3 * max(abs(v), 1e-6),
                      f"step 1 {k}: {label} {first[label][k]} vs default {v}")
            log(f"step 1, {label} vs default: " + " ".join(
                f"{k} {first[label][k]:.6g}/{v:.6g}" for k, v in first["default"].items()))
        del state  # the next path's peak memory holds its own state only
    log("train ms/step (median of steps 2.., CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in step_ms.items()))
    log("--- loop: cli train, export, train --resume ---")
    loop_counts, dataset, loop_ms = loop_phase(device, smi, step_ms["default"],
                                               dispatch_ms["default"])
    counts.update(loop_counts)
    log("--- device loader: cli train data.loader=device, the store, the captured chunk ---")
    counts.update(device_loader_phase(device, smi, dataset, loop_ms, step_ms["default"],
                                      dispatch_ms["default"]))

    # Nothing of JAX came in, not even through a library the port imports.
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "colvo"))
    check(loaded == [], f"modules of JAX or colvo loaded: {loaded[:8]}")

    table = []
    for key, name, src, replaces, counter in KERNELS:
        r = rows[key]
        bound_ms, bound_by = r["bound"]
        cold = f", {r['cold_ms']:.4f} ms with a cold L2" if "cold_ms" in r else ""
        log(f"{name}: {r['ms']:.4f} ms on the device (CUDA graph){cold}, {r['eager_ms']:.4f} ms "
            f"eager through the wrapper; plain {r['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms")
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[counter], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
