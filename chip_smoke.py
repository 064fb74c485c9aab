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
   versions on the card, F also at a shape that cuts its tiles, at
   ``loss.photo_native``'s 64×80 and 32×40 grids, and at windows 0, 4 and
   15; times kernel, plain version and the nearest single
   PyTorch call on the device (CUDA-graph replays between CUDA events),
   the kernel's eager call through its wrapper, and F with the L2 flushed
   before each call. Kernel P (the loss's projection of a depth grid to
   its two sources, forward and backward) against autograd through the
   plain ``ops.project(ops.backproject(...))`` in float64 at the training
   cell's four grids (B=12), its backward twice bit for bit, timed at the
   full-resolution grid (replayed, warm and cold, and eager) beside the
   plain path's forward and forward + backward, and a default step's P
   against the plain path's. Kernel L (LCC's windowed calibration) at the
   photometric shape against the plain path (its float32 and float64
   ``avg_pool2d`` means), in ``affine`` and ``gain`` and in bfloat16, twice
   bit for bit, timed (replayed, warm and cold, and eager) beside the plain
   path. Kernel E (the SSIM+L1 error, forward and the warp's cotangent) at
   the photometric shape against the plain ``window.photometric_error``
   and its autograd gradient in float32 and float64, in bfloat16, twice
   bit for bit, timed (replayed, warm and cold, and eager) beside the
   plain path. Kernel FA (MPViT's factorized attention, forward and
   backward) at MPViT-Small's four stage shapes over 36 frames, each output
   part against the plain op in float64, twice bit for bit, timed
   (replayed, warm and cold, and eager) beside the plain op; its rows are
   a default step's 38 calls each way. Kernel A (the clip's A/sumsq and
   A/clip, Adam's A/step) at the three training cells' parameter lists:
   one step bit for bit the foreach chain's, the norm within 1e-6 of
   float64's, each pass timed (replayed, warm and cold, and eager) beside
   the plain chain and, for A/step, ``torch.optim.Adam(fused=True)``.
   Every kernel's registers and spills come from the
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
   MPViT phase: a default step of ``model.depth_net="mpvit_s"`` with the
   launch counters reset just before it (38 ``FA/fwd``, 38 ``FA/bwd``),
   then one more step of it and one of the ResNet under the profiler: the
   kernels of MPViT's depthwise convolutions, and none of another op's,
   are those the benchmark's ``dwconv_ms.mpvit`` counts.
   Knob phase: the off-default training configurations (``KNOB_PATHS``:
   each of the seven loss protocols alone, ``photo_native`` with
   ``fused_kernel``, ``batched_photo`` with bf16 planes, ``model.remat``,
   ``model.batched_snippet=false``, ``train.adam_mu_dtype=bfloat16``), each
   a slice run of 3 steps through ``make_train_step`` (a captured step, as
   ``cli train`` takes it) and a held-out loss from the same weights and
   batches, with the same checks (launch counts derived from the config by
   ``expected_launches``, the warm-up's step included); the knobs that compute the default's function
   held to the default's step 1; ms/step, device busy and peak memory
   beside the default's. Then one ``make_scan_train`` chunk (K=4) under
   ``model.remat`` + ``loss.photo_remat`` + the bf16 Adam moment against an
   eager step on the same draws.
   Deterministic phase: kernel T's fixed-point variant (thread-block
   clusters) at the geo shapes, under a wild warp, at an odd width and on
   planes too large for a cluster (its global path), bit for bit the plain
   fixed-point version on the card, 20 calls bit for bit and within T's
   tolerance of the float plain version, a NaN plane, timed beside the
   float T, its device time split by operation (``det_split``); then two
   fresh processes of ``cli train --train.deterministic=true`` one after
   the other, 5 steps each on the same data and seed, whose step-4
   checkpoints must be equal bit for bit, and a fresh process of the
   default step: each one's ms/step and the device busy ms of its last
   step.
   Data-parallel phase: the same deterministic ``cli train`` as one NCCL
   rank under ``torch.distributed.run``, its step-4 checkpoint bit for bit
   the single process's; two gloo ranks sharing the card, 6 rows each of
   the slice phase's batches from its initial weights, 2 steps (the
   ranks' weights bit-equal after each, each rank's launches, ms/step,
   step 1 against the slice phase's and one process's), then a float32
   step with TF32 and cuDNN off, whose loss terms and pre-clip gradients
   must equal one process's on the global batch within the CPU test's
   bounds.
5. Serving phase, after the default path's steps:
   ``InferenceRunner.infer_coupled`` on frame pairs.
6. VO phase, on the same weights: ``run_vo`` streams a rendered 64-frame
   sequence at full width (uint8 RGB in, float16 wire; the init and chunk
   steps are replays of the runner's programs); its trajectory
   and depths must be sane, its float32 wire must agree with per-pair
   ``infer_coupled``, the float16 and uint8 wires and I420 input must stay
   within their bounds, symmetric pose must keep the forward translation,
   and the native pose chain must equal the numpy one. ATE/RPE, polyp
   errors and a stitched cloud (with a PLY round trip) follow, as in the
   reference's ``evaluate_synthetic``; no kernel may launch. Then
   frames/s of each input format and wire (at least 30), the layers of
   one chunk (the chunk step's eager body and its program's replay), the
   card's busy share and peak memory.
7. Loop phase: the training entry point at full width, in process through
   ``colvo_torch.cli``: ``train`` for 8 steps on the synthetic dataset
   (metrics every 2 steps, checkpoints every 4, the profiler over steps
   5-7, the eval hook at step 7), ``export``, ``train --resume`` to step
   10. The metrics rows, the eval hook's panels, the checkpoints, the
   resume, the step-8 checkpoint against the live state bit for bit, the
   export, run 1's steps as one captured step's replays and its launch
   counts (the slice's per step, times 8 replays plus the warm-up's) are
   checked; loop ms/step against the slice's, the card's busy share over
   the profiled steps, peak memory and the producer thread's ms a batch
   are printed. Then the dispatch-side NaN stop and a basin restart at
   64×96. Grain phase: ``cli train --data.loader=grain
   --train.deterministic=true`` 6 steps in a fresh process, then another
   resumed from its step-3 checkpoint: the step-6 checkpoints and
   ``loader.bin`` equal bit for bit; ms/step of each.
8. Device-loader phase: run 3 of ``cli train`` with ``data.loader=device``
   on the loop phase's dataset, as run 1 and checked as it is, with its
   ms/step beside run 1's, the interval between steps, the busy share,
   peak memory, the store's upload and the eval hook's split (its first
   call captures the forward); a store of 100 × 100 frames at
   256×320 (2.46 GB of uint8, tiled): its upload, one batch's gather +
   augment, its memory; ``make_scan_train`` at K=4 against 4 eager train
   steps fed the same indices and augmentation draws (step 1's loss terms
   to 1e-3 relative), 3 replays (the counter, fresh indices, launches =
   captured × replays), the chunk's ms/step, busy share and peak memory.
9. Serving-CLI phase, on the default path's 6-step weights exported to
   ``.npz``: the VO phase's 64-frame sequence written as PNG frame dirs at
   256×320 and at 432×540 with the port's codec (the card's host has no
   cv2), then in process through ``colvo_torch.cli``: ``infer`` (its
   depths bit for bit the runner's, 64 PNGs), ``vo`` on the 432×540 dir
   (the area resize; trajectory, rotations, PLY round trip, figures),
   ``viz``, ``recon``, ``eval`` (the reference's ``metrics.json`` keys,
   finite; three figures), ``eval --data`` on a two-sequence benchmark
   dir (.npy depth, KITTI poses, 9-float K; 16-bit PNG depth, TUM poses,
   4-float K; the GT round trip), ``import-torch`` of a synthetic family
   checkpoint with ``vo`` and ``eval --data`` on its ``norm="none"``
   weights, whose float32 forward on the card equals the CPU's to 1e-4.
   No S, T or F launch. Prints the codec's, the resize's and I420's ms a
   frame (reading 256×320 PNG frames must reach 30 frames/s), ``infer``'s
   and ``vo``'s frames/s with their layers, ``vo``'s busy share, peak
   memory. An Adam7-interlaced frame reads as the non-interlaced one.
   Refine phase: ``refine_keyframe_poses`` on the reference test's
   perturbed pose at 256×320 (the error must shrink as there), then on
   the VO phase's 64 keyframes (one padded batch) against the plain
   sampler, with its launches (one warm-up call, then a replay a batch)
   and ms a call.
   Graphs phase: each captured program against its eager body from the
   same inputs and state, with both times: ``infer_coupled`` and
   ``run_vo`` in every input format and wire bit for bit; 3 default
   steps (step 1's loss terms bit for bit, grad_norm and weights within
   1e-3) and the captured step's peak memory against the eager step's
   (at most 2×); 3 deterministic steps bit for bit in a fresh process;
   the loop on the numpy, grain and device loaders, 9 steps each, one
   captured step's replays with exact launches, and the card's busy
   share over 8 profiled replays; ``refine_keyframe_poses`` within 1e-6;
   the device store's batch program (3 batches bit for bit the eager
   gather + ``device_augment`` from one seed, no kernel launched) and the
   eval hook's forward program (bit for bit its eager body, or within
   1e-6 of max with the reason logged; 3 hook calls on one program, each
   split into the wait for queued work, forward, host metrics and panel
   writes), each with its
   replay and eager ms.
10. Demo phase: ``colvo_torch.scripts.demo_synthetic.main`` at full width,
   cut to 400 steps with the eval hook every 3 epochs (41 steps an epoch:
   a capture and two replays): every step's loss finite and the last 20
   steps' mean below the first 20's, finite ``eval/*`` rows, the panels,
   exact launches, the exported weights loaded by ``make_runner``,
   ``evaluate_synthetic``'s metrics finite and its three figures; ms/step
   and the Abs-Rel reached. Full-colon phase:
   ``colvo_torch.scripts.fullcolon.main`` on the demo's weights at 600
   frames (the reference's 3,000, cut) with keyframe refinement: finite
   ATE and polyp errors, non-empty clouds, the PLY, the refinement's
   launches; VO frames/s.
11. Ablation phase: ``colvo_torch.scripts.ablate.run_cell`` for
   ``dcdp1_lcc1`` and ``expjit_dcdp1_lccG`` at full width, 60 steps on a
   corpus cut to 2 × 16 frames (8 × 64 uncut): each cell's launches
   exactly (60 replays and the warm-up) × a step's, finite records with
   the reference's keys, a resumed cell returning its record with no
   launch, ``ABLATION.md``'s two rows, the second cell's peak memory
   within 10 % of the first's; ms/step and each stage's seconds. Then the
   restart cell (``gauge_validate``'s ``dcdp1_lcc1_restart`` at seed
   1234, the check at step 3 and ``train.restart_max`` 1): one
   ``restart/attempt`` row with the new seed, launches exactly (the steps
   of both attempts and two warm-ups) × a step's, exported weights moved
   away from the new seed's init, its peak memory within 10 % of the first
   cell's. Then
   ``figures``, ``scale_decoupling`` and ``gauge_probe`` on those cells
   (two PNGs; rows for the two cells, the others skipped; no launch);
   ``drift_audit`` (98 frames: three batches of 32 pairs and one padded,
   one pose program), ``expjit_analysis`` (48 frames, the two cells'
   rows and four maps, the other two skipped, each cell's peak memory)
   and ``expjit_mechanism`` (33 frames: H1-H4 finite, exactly four
   launches of S value-only at C=3 and none from the other two); and
   ``longvideo``'s two arms at 300 frames (3,000 uncut) on their weights:
   finite drift curves, the renorm A/B, host RSS flat within 300 MB, the
   device's peak memory, the report and its figure, no launch; frames/s.
12. Prints the kernel table as one JSON line (launches over the slice
   and knob runs, the deterministic runs, the data-parallel ranks, loop
   run 1, the grain runs, the device-loader run, the chunks' replays and
   the refine calls, the graphs phase, the demo's steps, the full-colon
   run's refinement, the ablation's cells and ``expjit_mechanism``'s
   warps; every kernel must have launched), then the device
   line ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails without a CUDA card, or where ``colvo_torch`` is absent.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import struct
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
from colvo_torch.geometry.ops import bilinear_taps  # noqa: E402
from colvo_torch.data import batch_iterator, synthetic_dataset  # noqa: E402
from colvo_torch.kernels import build, launch_counts, project_depth, reset_launch_counts  # noqa: E402
from colvo_torch.kernels.factor_attention import (  # noqa: E402
    backward as fa_backward, factor_attention, factor_attention_plain, forward as fa_forward)
from colvo_torch.kernels import adam, fused_loss, lcc, project, sampler, scatter, ssim, window  # noqa: E402
from colvo_torch.losses.photometric import lcc_calibrate  # noqa: E402
from colvo_torch.runtime import InferenceRunner, init_state, loss_fn, to_device, train_step  # noqa: E402
from colvo_torch.runtime import graphs, spans  # noqa: E402

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
# loss.photo_native + fused_kernel runs F on each scale's own grid; at the
# two smallest a window-15 LCC covers most of the grid and every tile is a
# border tile.
FUSED_NATIVE = (((12, 3, 64, 80), (64, 80)), ((12, 3, 32, 40), (32, 40)))
FLUSH_BYTES = 64 * 2**20  # more than the H100's 50 MB L2
TRAIN_STEPS = 6
# f32 operations of F per output pixel: the tap arithmetic once, and per
# channel the lerps (6), the four window-L sums taken separably with the
# two products (2 + 8·(L−1)), the LCC statistics and ŵ (17), the five 3×3
# sums taken separably with three products (3 + 20), the SSIM moments and
# value (23) and the L1 and channel sums (4); the backward adds per channel
# the coordinate derivatives (4), the SSIM terms G1-G3 and F1-F3 (30), the
# three 3×3 transposed sums (12), dŵ, dw and the two channel sums (12).
# Kernel P at the training cell's grids: B, sources, and f32 operations a
# pixel: the ray once (6), per source the point, R p + t, K c and the
# divides (36); the backward recomputes them and adds per source the
# cotangents of u, c and p, d_depth and the 12 pose sums (73).
PROJ_N, PROJ_SOURCES = 12, 2
P_RAY_OPS, P_FWD_OPS, P_BWD_OPS = 6, 36, 36 + 73
TOL_PROJ_FWD_REL, TOL_PROJ_BWD_REL = 1e-5, 1e-4
F_TAP_OPS = 12
F_FWD_OPS = 6 + 2 + 8 * (LCC_WINDOW - 1) + 17 + 3 + 20 + 23 + 4
F_BWD_OPS = F_FWD_OPS + 4 + 30 + 12 + 12
# Kernel L: f32 operations a pixel and channel, the two products, the four
# running sums each way (an add and a subtract each, 2 · 2 · 4) and the
# statistics, a and ŵ (17); the floors of its comparison with the float64
# plain path (ŵ, a), as tests/test_torch_port_lcc_emu.py's.
L_OPS = 2 + 16 + 17
LCC_FLOOR = (2e-6, 2e-5)
# Kernel E: f32 operations a pixel and channel: forward the nine taps of
# the five 3×3 sums (three products and five adds each, 72), the moments
# (8), SSIM (12) and the L1 and channel sums (4); the backward recomputes
# the moments (80), adds the window's terms (20) and the nine taps of the
# transpose (seven each, 63) and dŵ (4). The floors of its comparison with
# the float64 plain path (e, the warp's cotangent, of the largest
# magnitude), as tests/test_torch_port_ssim_emu.py's.
E_FWD_OPS = 72 + 8 + 12 + 4
E_BWD_OPS = 80 + 20 + 63 + 4
SSIM_FLOOR = (1e-6, 1e-5)
# Kernel FA at MPViT-Small's four stages at 256×320 over a default step's
# B·3 = 36 frames, 8 heads: (tokens, width, path-layers a step), so d = 8,
# 16, 27 and 36 and 2·1 + 3·3 + 3·6 + 3·3 = 38 calls each way. Bytes an
# (F, N, C) element a call moves once in bfloat16: the forward reads q, k,
# v and cv and writes out; the backward reads q, k, v, g and cv and writes
# dq, dk, dv and dcv. f32 operations an element: forward the column max,
# exp and sum (4), Pᵀv (2d) and q·KV with the scale and q ∘ cv (2d + 3);
# backward qᵀg (2d), P again (3), dq (2d + 3), dv (2d), dk (2d + 2) and dcv
# (1). Each output part (out, dq, dk, dv, dcv) is held to TOL_FA of its own
# largest magnitude against float64 on the same bfloat16 inputs: the
# bfloat16 store's rounding (2⁻⁹ of an element) twice over for the float32
# sums of up to 5,120 terms before it.
FA_HEADS, FA_FRAMES = 8, 36
FA_STAGES = ((5120, 64, 2), (1280, 128, 9), (320, 216, 18), (80, 288, 9))
FA_FWD_BYTES, FA_BWD_BYTES = 5 * 2, 9 * 2
FA_FWD_OPS = lambda d: 4 * d + 7  # noqa: E731
FA_BWD_OPS = lambda d: 8 * d + 9  # noqa: E731
TOL_FA = 2 * 2.0**-8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# Calls a captured program runs eagerly on a side stream before its capture;
# its first call then replays once.
STEP_WARMUP = graphs.WARMUP


def wrap_step_fns(wrap):
    """Patch ``runtime.loop.make_step_fn`` so that every step function the
    loop makes (a captured ``TrainStep``, or the eager branch) is
    ``wrap(step_fn)``."""
    from colvo_torch.runtime import loop as loop_mod

    real = loop_mod.make_step_fn
    return mock.patch.object(loop_mod, "make_step_fn", lambda state, cfg: wrap(real(state, cfg)))


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
    """Hold S, T, F, P, L and E against their plain versions; returns the
    kernel rows (without launch counts) keyed P1..P8, P/fwd, P/bwd, L,
    E/fwd and E/bwd."""
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
    rows.update(project_rows(device, gen, geo_scales, timer, eager, cold))
    rows.update(lcc_rows(device, gen, photo, timer, eager, cold))
    rows.update(ssim_rows(device, gen, photo, timer, eager, cold))
    rows.update(fa_rows(device, timer, eager, cold, timed))
    rows.update(adam_rows(device, timer, eager, cold))
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
        w_hat = lcc.window_plain(w_hat, t, window, (0.5, 2.0), "affine")
    ties = (w_hat - t).abs().amin(-1) < TIE_GAP
    err_b = diff[~ties].max().item()
    check(bool(torch.isfinite(e).all() and torch.isfinite(gx).all() and torch.isfinite(gy).all()),
          "F finite")
    return err_f, err_b, err_b / scale, ties


def fused_rows(device, gen, photo, timer, eager, cold):
    """P7, P8: the fused error map and its coordinate cotangent against
    their plain versions at the per-source photometric shape, at
    ``FUSED_SEAM`` and at ``FUSED_NATIVE``, each at ``FUSED_WINDOWS``; timed at the photometric
    shape and ``LCC_WINDOW``, with a warm and a cold L2."""
    b, c, h, w = photo
    main = fused_inputs(gen, photo, (h, w), 3, device)
    worst = {"P7": 0.0, "P8": 0.0}
    for shape, src_hw in ((photo, (h, w)), FUSED_SEAM, *FUSED_NATIVE):
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


def project_inputs(gen, h: int, w: int, device) -> tuple:
    """Kernel P's inputs on an h×w grid: depth (B, h, w) from uniform
    disparities, a pinhole K per row and its inverse, small poses as
    (S, B, 4, 4) transforms, and cotangents of x, y and z."""
    from colvo_torch.data.synthetic import default_intrinsics
    from colvo_torch.geometry import disp_to_depth, transformation_from_parameters

    depth = disp_to_depth(0.02 + 0.96 * torch.rand((PROJ_N, h, w), generator=gen))[1]
    k = torch.tensor(default_intrinsics(h, w)).repeat(PROJ_N, 1, 1)
    k[:, 0, 2] += 4 * torch.rand(PROJ_N, generator=gen) - 2
    poses = 0.02 * torch.randn((PROJ_N, PROJ_SOURCES, 6), generator=gen)
    t = transformation_from_parameters(poses[..., :3], poses[..., 3:]).transpose(0, 1)
    g = torch.randn((3, PROJ_SOURCES * PROJ_N, h, w), generator=gen)
    return (tuple(a.to(device) for a in (depth, k, torch.linalg.inv(k).contiguous(), t)),
            tuple(a.to(device) for a in g.unbind(0)))


def _grid_rel_err(got, want) -> float:
    """max |got − want| / (|want| + the largest |want| of its grid), for
    got and want (A, N, B) over N grids."""
    got, want = got.double(), want.double()
    scale = want.abs() + want.abs().amax(dim=(0, 2), keepdim=True)
    return ((got - want).abs() / scale).max().item()


def project_parity(mats, gs) -> tuple:
    """P's x, y, z and d_depth, d_T against autograd through the plain path
    in float64 on the same inputs: the largest errors relative to the value
    and the largest of its grid."""
    depth, k, k_inv, t = mats
    out = project.forward(*mats)
    d_depth, d_t = project.backward(*mats, *gs)
    d64, t64 = depth.double().requires_grad_(), t.double().requires_grad_()
    want = project.project_plain(d64, k.double(), k_inv.double(), t64)
    torch.autograd.backward(want, [g.double() for g in gs])
    n, s = depth.shape[0], t.shape[0]
    err_f = max(_grid_rel_err(o.reshape(s, n, -1), w.detach().reshape(s, n, -1))
                for o, w in zip(out, want))
    err_b = max(_grid_rel_err(d_depth.reshape(1, n, -1), d64.grad.reshape(1, n, -1)),
                _grid_rel_err(d_t.reshape(s, n, -1), t64.grad.reshape(s, n, -1)))
    check(all(bool(torch.isfinite(a).all()) for a in (*out, d_depth, d_t)), "P finite")
    check(bool((d_t[:, :, 3] == 0).all()), "P: d_T's bottom rows are zero")
    return err_f, err_b


def project_rows(device, gen, geo_scales, timer, eager, cold):
    """P/fwd, P/bwd: kernel P against the plain path at the training cell's
    four grids (B=12, two sources), its backward twice bit for bit; timed
    at the full-resolution grid, and a default step's P (the photometric
    projection of each scale at full resolution, the geo one at its own
    grid) against the plain path's forward and backward."""
    grids = {hw: project_inputs(gen, *hw, device) for hw in geo_scales}
    for hw, (mats, gs) in grids.items():
        err_f, err_b = project_parity(mats, gs)
        log(f"P {PROJ_N}x{hw[0]}x{hw[1]}, {PROJ_SOURCES} sources: |x, y, z| {err_f:.3g}, "
            f"|d_depth, d_T| {err_b:.3g} (of the value and its grid's largest, vs float64)")
        check(err_f <= TOL_PROJ_FWD_REL and err_b <= TOL_PROJ_BWD_REL, f"P vs plain at {hw}")
    mats, gs = grids[geo_scales[0]]
    first, second = project.backward(*mats, *gs), project.backward(*mats, *gs)
    check(all(same_bits(a, b) for a, b in zip(first, second)), "P backward: the same bits twice")
    depth, k, k_inv, t = mats
    d_req, t_req = depth.clone().requires_grad_(), t.clone().requires_grad_()

    def step_of(fn):
        return lambda: torch.autograd.grad(fn(d_req, k, k_inv, t_req), (d_req, t_req), gs)

    px = depth.numel()
    fwd_bytes = 4 * px * (1 + 3 * PROJ_SOURCES)
    bwd_bytes = 4 * px * (2 + 3 * PROJ_SOURCES)
    fwd = lambda: project.forward(*mats)  # noqa: E731
    bwd = lambda: project.backward(*mats, *gs)  # noqa: E731
    rows = {
        "P/fwd": dict(
            max_abs_err=None, ms=timer(fwd), cold_ms=cold(fwd),
            eager_ms=eager(lambda: project_depth(*mats)),
            plain_ms=timer(lambda: project.project_plain(*mats)), library_ms=None,
            bound=bound(fwd_bytes, px * (P_RAY_OPS + P_FWD_OPS * PROJ_SOURCES)),
        ),
        "P/bwd": dict(
            max_abs_err=None, ms=timer(bwd), cold_ms=cold(bwd),
            eager_ms=eager(bwd),
            plain_ms=timer(step_of(project.project_plain)), library_ms=None,
            bound=bound(bwd_bytes, px * (P_RAY_OPS + P_BWD_OPS * PROJ_SOURCES)),
        ),
    }
    # a default step: the photometric grid of every scale at full resolution,
    # the geo grid of each scale at its own size
    step_ms = {"P": 0.0, "plain": 0.0}
    for hw in (*[geo_scales[0]] * len(geo_scales), *geo_scales):
        (dm, km, kim, tm), gm = grids[hw]
        dq, tq = dm.clone().requires_grad_(), tm.clone().requires_grad_()
        for key, fn in (("P", project_depth), ("plain", project.project_plain)):
            step_ms[key] += timer(lambda fn=fn: torch.autograd.grad(fn(dq, km, kim, tq), (dq, tq),
                                                                   gm))
    log(f"P at {PROJ_N}x{geo_scales[0][0]}x{geo_scales[0][1]}: forward {rows['P/fwd']['ms']:.4f} "
        f"ms (cold {rows['P/fwd']['cold_ms']:.4f}, eager {rows['P/fwd']['eager_ms']:.4f}; plain "
        f"{rows['P/fwd']['plain_ms']:.4f}), backward {rows['P/bwd']['ms']:.4f} ms (cold "
        f"{rows['P/bwd']['cold_ms']:.4f}; the plain forward + backward "
        f"{rows['P/bwd']['plain_ms']:.4f}); bounds {rows['P/fwd']['bound'][0]:.4f} and "
        f"{rows['P/bwd']['bound'][0]:.4f} ms; a default step's projections forward + backward: "
        f"P {step_ms['P']:.4f} ms, plain {step_ms['plain']:.4f} ms")
    return rows


def lcc_forward_plain(warped, target, window, clip, mode, with_a):
    """``lcc.forward`` by its plain version (ŵ; no a: only no-grad calls
    take it), in L's arithmetic: float32, stored in the frames' dtype."""
    out = lcc.window_plain(warped.float(), target.float(), window, clip, mode)
    return out.to(warped.dtype), None


def lcc_inputs(gen, photo, device):
    """Kernel L's inputs at the photometric shape (B, C, H, W): the warp as
    the loss hands it (a permuted plane stack, (B, H, W, C)) with smooth
    structure and noise, and an interleaved target that relights it by a
    gain and an offset varying across the frame."""
    b, c, h, w = photo
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h), torch.linspace(0, 1, w), indexing="ij")
    base = (0.5 + 0.3 * torch.sin(6 * xx + 4 * yy)[None, :, :, None]
            + 0.2 * torch.rand((b, h, w, c), generator=gen))
    tgt = ((0.7 + 0.5 * xx[None, :, :, None]) * base + 0.1 * yy[None, :, :, None]
           + 0.02 * torch.rand((b, h, w, c), generator=gen)).clamp(0, 1.5)
    warp = base.permute(0, 3, 1, 2).contiguous().to(device).permute(0, 2, 3, 1)
    return warp, tgt.contiguous().to(device)


def lcc_rows(device, gen, photo, timer, eager, cold):
    """L: LCC's windowed calibration at the photometric shape against the
    plain path: ŵ and a no farther from the float64 plain path than twice
    the float32 plain path's distance plus ``LCC_FLOOR``, in ``affine`` and
    ``gain``; bfloat16 within one bfloat16 unit in the last place of the
    float32 plain path; two calls bit for bit. Timed (replayed, warm and
    cold, and eager through the wrapper) beside the plain path, which is
    also the nearest PyTorch: its ``avg_pool2d`` means."""
    warp, target = lcc_inputs(gen, photo, device)
    worst = 0.0

    def plain(w, t, mode, dtype):
        x = w.to(dtype).requires_grad_()
        out = lcc.window_plain(x, t.to(dtype), LCC_WINDOW, (0.5, 2.0), mode)
        (a,) = torch.autograd.grad(out, x, torch.ones_like(out))
        return out.detach(), a

    def gap(got, want):
        return (got.double() - want.double()).abs().max().item()

    for mode in ("affine", "gain"):
        got = lcc.forward(warp, target, LCC_WINDOW, (0.5, 2.0), mode, True)
        want64, want32 = plain(warp, target, mode, torch.float64), plain(warp, target, mode,
                                                                          torch.float32)
        gaps = [(gap(g, w64), gap(w32, w64)) for g, w64, w32 in zip(got, want64, want32)]
        log(f"L {mode} at {tuple(warp.shape)}: off the float64 plain path ŵ {gaps[0][0]:.3g} "
            f"(plain float32 {gaps[0][1]:.3g}), a {gaps[1][0]:.3g} ({gaps[1][1]:.3g})")
        check(all(k <= 2 * p + f for (k, p), f in zip(gaps, LCC_FLOOR)),
              f"L {mode} vs the plain path")
        check(all(bool(torch.isfinite(g).all()) for g in got), "L finite")
        again = lcc.forward(warp, target, LCC_WINDOW, (0.5, 2.0), mode, True)
        check(all(same_bits(a, b) for a, b in zip(got, again)), f"L {mode}: the same bits twice")
        worst = max(worst, gaps[0][0])
    wb, tb = warp.to(torch.bfloat16), target.to(torch.bfloat16)
    got = lcc.forward(wb, tb, LCC_WINDOW, (0.5, 2.0), "affine", True)
    for g, ref in zip(got, plain(wb, tb, "affine", torch.float32)):
        check(bool(((g.float() - ref).abs() <= 2.0**-7 * ref.abs() + 1e-5).all()),
              "L bfloat16 within one unit in the last place of the float32 plain path")
    fn = lambda: lcc.forward(warp, target, LCC_WINDOW, (0.5, 2.0), "affine", True)  # noqa: E731
    row = dict(
        max_abs_err=worst, ms=timer(fn), cold_ms=cold(fn),
        eager_ms=eager(lambda: lcc_calibrate(warp, target, "affine", LCC_WINDOW)),
        plain_ms=timer(lambda: lcc.window_plain(warp, target, LCC_WINDOW, (0.5, 2.0), "affine")),
        library_ms=None,
        bound=bound(4 * 4 * warp.numel(), warp.numel() * L_OPS),
    )
    bf16_ms = timer(lambda: lcc.forward(wb, tb, LCC_WINDOW, (0.5, 2.0), "affine", True))
    log(f"L at {tuple(warp.shape)}, L={LCC_WINDOW}: {row['ms']:.4f} ms (cold {row['cold_ms']:.4f}, "
        f"eager {row['eager_ms']:.4f}, bfloat16 {bf16_ms:.4f}); plain {row['plain_ms']:.4f} ms; "
        f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]}); a default step's 8 calls: "
        f"{8 * row['ms']:.4f} ms against {8 * row['plain_ms']:.4f}")
    return {"L": row}


def ssim_forward_plain(pred, target, alpha):
    """``ssim.forward`` by its plain version, in E's arithmetic: float32,
    stored in the frames' dtype."""
    return window.photometric_error(pred.float(), target.float(), alpha).to(pred.dtype)


def ssim_rows(device, gen, photo, timer, eager, cold):
    """E/fwd, E/bwd: the SSIM+L1 error and the warp's cotangent at the
    photometric shape (L's inputs: a permuted plane stack against an
    interleaved target) against the plain ``window.photometric_error`` and
    its autograd gradient: no farther from the float64 plain path than
    twice the float32 plain path's distance plus ``SSIM_FLOOR`` of the
    largest magnitude; bfloat16 within that plus one bfloat16 unit in the
    last place; two calls bit for bit. Timed (replayed, warm and cold, and
    eager through the wrapper) beside the plain path, whose ``avg_pool2d``
    means are the nearest PyTorch."""
    warp, target = lcc_inputs(gen, photo, device)
    g = torch.randn(warp.shape[:-1], generator=gen).to(device)

    def both(w, t, gg):
        return ssim.forward(w, t, ALPHA), ssim.backward(w, t, gg, ALPHA)

    def plain(w, t, gg, dtype):
        w, t, gg = w.to(dtype), t.to(dtype), gg.to(dtype)
        return (window.photometric_error(w, t, ALPHA), ssim.backward_plain(w, t, gg, ALPHA))

    def gap(got, want):
        return (got.double() - want.double()).abs().max().item()

    got = both(warp, target, g)
    want64, want32 = plain(warp, target, g, torch.float64), plain(warp, target, g, torch.float32)
    gaps = [(gap(k, w64), gap(w32, w64), f * w64.abs().max().item())
            for k, w64, w32, f in zip(got, want64, want32, SSIM_FLOOR)]
    log(f"E at {tuple(warp.shape)}: off the float64 plain path e {gaps[0][0]:.3g} (plain "
        f"float32 {gaps[0][1]:.3g}), the warp's cotangent {gaps[1][0]:.3g} ({gaps[1][1]:.3g})")
    check(all(k <= 2 * p + f for k, p, f in gaps), "E vs the plain path")
    check(all(bool(torch.isfinite(x).all()) for x in got), "E finite")
    check(got[1].stride() == warp.stride(), "E: the cotangent in the warp's layout")
    again = both(warp, target, g)
    check(all(same_bits(a, b) for a, b in zip(got, again)), "E: the same bits twice")
    wb, tb, gb = warp.to(torch.bfloat16), target.to(torch.bfloat16), g.to(torch.bfloat16)
    for x, w64, w32 in zip(both(wb, tb, gb), plain(wb, tb, gb, torch.float64),
                           plain(wb, tb, gb, torch.float32)):
        check(bool(((x.double() - w64).abs() <= 2 * gap(w32, w64) + 2.0**-7 * w64.abs()).all()),
              "E bfloat16 within one unit in the last place of its float32 arithmetic")
    x_req = warp.clone().requires_grad_()

    def grad_of(fn):
        return lambda: torch.autograd.grad(fn(x_req, target, ALPHA), x_req, g)

    px, c = warp[..., 0].numel(), warp.shape[-1]
    fwd = lambda: ssim.forward(warp, target, ALPHA)  # noqa: E731
    bwd = lambda: ssim.backward(warp, target, g, ALPHA)  # noqa: E731
    rows = {}
    for key, fn, eager_fn, plain_fn, n_bytes, ops, kernel in (
            ("E/fwd", fwd, lambda: ssim.ssim_error(warp, target, ALPHA),
             lambda: window.photometric_error(warp, target, ALPHA), 4 * px * (2 * c + 1),
             px * c * E_FWD_OPS, "ssim_err_fwd_kernelIfLi3E"),
            ("E/bwd", bwd, grad_of(ssim.ssim_error), grad_of(window.photometric_error),
             4 * px * (3 * c + 1), px * c * E_BWD_OPS, "ssim_err_bwd_kernelIfLi3E")):
        rows[key] = dict(
            max_abs_err=gaps[key == "E/bwd"][0], ms=timer(fn), cold_ms=cold(fn),
            eager_ms=eager(eager_fn), plain_ms=timer(plain_fn), library_ms=None,
            bound=bound(n_bytes, ops), registers=ptxas_entry("ssim", kernel)[0],
            smem_bytes=ssim.smem_bytes(c, key == "E/bwd"),
        )
    bf16_ms = timer(lambda: ssim.forward(wb, tb, ALPHA))
    log(f"E at {tuple(warp.shape)}: forward {rows['E/fwd']['ms']:.4f} ms (cold "
        f"{rows['E/fwd']['cold_ms']:.4f}, eager {rows['E/fwd']['eager_ms']:.4f}, bfloat16 "
        f"{bf16_ms:.4f}; plain {rows['E/fwd']['plain_ms']:.4f}), backward "
        f"{rows['E/bwd']['ms']:.4f} ms (cold {rows['E/bwd']['cold_ms']:.4f}; eager forward + "
        f"backward {rows['E/bwd']['eager_ms']:.4f}, plain {rows['E/bwd']['plain_ms']:.4f}); "
        f"bounds {rows['E/fwd']['bound'][0]:.4f} and {rows['E/bwd']['bound'][0]:.4f} ms; "
        f"registers {rows['E/fwd']['registers']} and {rows['E/bwd']['registers']}, shared "
        f"memory {rows['E/fwd']['smem_bytes']} and {rows['E/bwd']['smem_bytes']} B a CTA; a "
        f"default step's 10 forwards and 8 backwards: "
        f"{10 * rows['E/fwd']['ms'] + 8 * rows['E/bwd']['ms']:.4f} ms")
    return rows


def fa_inputs(device, n: int, c: int, seed: int) -> tuple:
    """qkv (F, N, 3·C), cv and a cotangent g (F, N, C), bfloat16, with k
    three times wider than q and v: a peaked softmax over the tokens."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(FA_FRAMES, n, 3 * c, generator=gen)
    qkv[..., c:2 * c] *= 3.0
    cv, g = (torch.randn(FA_FRAMES, n, c, generator=gen) for _ in range(2))
    return tuple(x.to(device, torch.bfloat16) for x in (qkv, cv, g))


def fa_parity(qkv, cv, g) -> dict:
    """Each output part of FA (forward and backward through the wrapper)
    against the plain op and its autograd gradient in float64 on the same
    inputs: {part: (gap, largest magnitude)}; checks the bits of a second
    call."""
    def run(fn, dtype):
        a, b = qkv.to(dtype).requires_grad_(True), cv.to(dtype).requires_grad_(True)
        out = fn(a, b, FA_HEADS)
        da, db = torch.autograd.grad(out, (a, b), g.to(dtype))
        f, n, c3 = da.shape
        return (out.detach(), *da.view(f, n, 3, c3 // 3).unbind(2), db)

    got = run(factor_attention, torch.bfloat16)
    again = run(factor_attention, torch.bfloat16)
    check(all(same_bits(a, b) for a, b in zip(got, again)), "FA: the same bits twice")
    check(all(bool(torch.isfinite(x).all()) for x in got), "FA finite")
    want = run(factor_attention_plain, torch.float64)
    return {part: ((x.double() - y).abs().max().item(), y.abs().max().item())
            for part, x, y in zip(("out", "dq", "dk", "dv", "dcv"), got, want)}


PLAIN_OF = {"FA/fwd": "forward", "FA/bwd": "forward + backward"}


def fa_rows(device, timer, eager, cold, timed=True):
    """FA/fwd, FA/bwd: kernel FA at MPViT-Small's four stage shapes (36
    frames, 8 heads), each output part (out; dq, dk, dv, dcv) against the
    plain op in float64 within ``TOL_FA`` of the part's largest magnitude,
    two calls bit for bit. Each shape timed forward and backward (replayed,
    warm and cold, and eager through the wrapper) beside the plain op (its
    forward replayed; its forward + backward by the device time of its
    kernels under the profiler, since its autograd backward does not
    capture: it makes the legacy stream wait on the capturing one); the
    rows are a default step's 38 forwards and 38 backwards, summed over the
    stages by their path-layers."""
    rows = {key: dict(max_abs_err=0.0, ms=0.0, cold_ms=0.0, eager_ms=0.0, plain_ms=0.0,
                      library_ms=None, bound=(0.0, "bytes"))
            for key in ("FA/fwd", "FA/bwd")}
    plain = factor_attention_plain
    profiled = (lambda fn: busy_share(fn)[0]) if timed else timer
    for n, c, calls in FA_STAGES:
        qkv, cv, g = fa_inputs(device, n, c, seed=n + c)
        gaps = fa_parity(qkv, cv, g)
        log(f"FA {FA_FRAMES}x{n}x{c} (d {c // FA_HEADS}): off float64, of each part's largest "
            "magnitude: " + ", ".join(f"{k} {gap / top:.3g}" for k, (gap, top) in gaps.items()))
        check(all(gap <= TOL_FA * top for gap, top in gaps.values()),
              f"FA vs the float64 plain op at {FA_FRAMES}x{n}x{c}")
        _, stats = fa_forward(qkv, cv, FA_HEADS)
        a, b = qkv.clone().requires_grad_(True), cv.clone().requires_grad_(True)

        def grad_of(fn):
            return lambda: torch.autograd.grad(fn(a, b, FA_HEADS), (a, b), g)

        elems, d = qkv.numel() // 3, c // FA_HEADS
        fwd = lambda: fa_forward(qkv, cv, FA_HEADS)  # noqa: E731
        bwd = lambda: fa_backward(qkv, cv, stats, g, FA_HEADS)  # noqa: E731
        stage = {}
        for key, fn, eager_fn, plain_ms, n_bytes, ops, parts in (
                ("FA/fwd", fwd, lambda: factor_attention(qkv, cv, FA_HEADS),
                 lambda: timer(lambda: plain(qkv, cv, FA_HEADS)), FA_FWD_BYTES * elems,
                 FA_FWD_OPS(d) * elems, ("out",)),
                ("FA/bwd", bwd, grad_of(factor_attention), lambda: profiled(grad_of(plain)),
                 FA_BWD_BYTES * elems, FA_BWD_OPS(d) * elems, ("dq", "dk", "dv", "dcv"))):
            stage[key] = dict(ms=timer(fn), cold_ms=cold(fn), eager_ms=eager(eager_fn),
                              plain_ms=plain_ms(), bound=bound(n_bytes, ops))
            r = rows[key]
            for k in ("ms", "cold_ms", "eager_ms", "plain_ms"):
                r[k] += calls * stage[key][k]
            r["bound"] = (r["bound"][0] + calls * stage[key]["bound"][0],
                          "bytes" if stage[key]["bound"][1] == "bytes" else r["bound"][1])
            r["max_abs_err"] = max(r["max_abs_err"], max(gaps[p][0] / gaps[p][1] for p in parts))
        log(f"FA {FA_FRAMES}x{n}x{c}, a call: " + "; ".join(
            f"{key} {v['ms']:.4f} ms (cold {v['cold_ms']:.4f}, eager {v['eager_ms']:.4f}; plain "
            f"{PLAIN_OF[key]} {v['plain_ms']:.4f}; bound {v['bound'][0]:.4f} by {v['bound'][1]})"
            for key, v in stage.items()))
    for key, r in rows.items():
        regs = [ptxas_entry("factor_attention", f"fa_{key[3:]}_{part}")[0]
                for part in ("reduceI13__nv_bfloat16", "combine", "applyI13__nv_bfloat16")]
        r["registers"] = max(regs)
        log(f"{key}, a default step's 38 calls: {r['ms']:.4f} ms (cold {r['cold_ms']:.4f}, "
            f"eager {r['eager_ms']:.4f}; plain {PLAIN_OF[key]} {r['plain_ms']:.4f}), bound "
            f"{r['bound'][0]:.4f} "
            f"ms ({r['ms'] / r['bound'][0]:.2f}x); registers of reduce, combine and apply "
            f"{regs}; the largest part's gap {r['max_abs_err']:.3g} of its largest magnitude")
    return rows


# The training cells' parameter lists, by benchmark configuration (A's rows).
ADAM_LISTS = (("default", "colvo_r18_gn"), ("mpvit", "colvo_mpvit_s"),
              ("dpt", "colvo_dav2_vitl"))
# Bytes a float32 parameter of each pass of A: A/sumsq reads g; A/clip, where
# it engages, reads and writes g; A/step reads p, g, μ (float32), ν and
# writes p, μ, ν.
ADAM_BYTES = {"A/sumsq": 4, "A/clip": 8, "A/step": 28}


def model_shapes(config: str) -> list:
    """The parameter shapes of a benchmark configuration's model (meta)."""
    from colvo_torch.models import ColVOModel

    cfg = ColvoConfig()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "configs",
                           f"{config}.json")) as f:
        overrides = json.load(f)["overrides"]
    cfg.apply_overrides([f"{k}={json.dumps(v)}" for k, v in overrides.items()])
    with torch.device("meta"):
        return [tuple(p.shape) for p in ColVOModel(cfg.model).parameters()]


def adam_rows(device, timer, eager, cold) -> dict:
    """A/sumsq, A/clip, A/step at each training cell's parameter list
    (``ADAM_LISTS``; float32 μ, the learning rate a device tensor): one
    step of A against the foreach chain (``adam.step_plain``) bit for bit,
    the norm against float64's, and the clip engaged (the limit half the
    norm) bit for bit the chain's scaling by A's own norm
    (``adam.clip_plain``'s scale and product); each pass timed (replayed,
    warm and cold; eager through the wrapper: A/sumsq as
    ``clip_global_norm`` below the limit, A/clip as it engages with a scale
    of -1, A/step as ``adam_update``) beside the plain chain (the clip's
    norm and scale; Adam's passes) and, for A/step,
    ``torch.optim.Adam(fused=True)`` on the same list (the yardstick, never
    on the port's path). Rows ``A/<pass>/<list>``; their ``max_abs_err``
    the norm's relative error (A/sumsq) and the largest difference from
    the chain (A/clip, A/step)."""
    rows = {}
    lib = adam.bind(build.library("adam"))
    stream = lambda: torch.cuda.current_stream(device).cuda_stream  # noqa: E731
    for label, config in ADAM_LISTS:
        shapes = model_shapes(config)
        gen = torch.Generator(device=device).manual_seed(11)
        ps = [torch.randn(s, device=device, generator=gen) for s in shapes]
        gs = [1e-3 * torch.randn(s, device=device, generator=gen) for s in shapes]
        ms = [1e-3 * torch.randn(s, device=device, generator=gen) for s in shapes]
        vs = [1e-6 * torch.rand(s, device=device, generator=gen) for s in shapes]
        steps = [torch.full((), 3.0, device=device) for _ in shapes]
        lr = torch.tensor(1e-4, device=device)
        n = sum(p.numel() for p in ps)
        args = (lr, (0.9, 0.999), 1e-8, 0.0)
        plans = adam.Plans()

        # parity: one step; the norm; the clip engaged
        ref = [[x.clone() for x in xs] for xs in (ps, ms, vs, steps)]
        adam.adam_update(ps, gs, ms, vs, steps, *args, plans=plans)
        adam.step_plain(ref[0], gs, ref[1], ref[2], ref[3], *args)
        pairs = [(x, y) for xs, ys in zip((ps, ms, vs, steps), ref) for x, y in zip(xs, ys)]
        same = all(torch.equal(x, y) for x, y in pairs)
        step_err = max(float((x - y).abs().max()) for x, y in pairs)
        del ref, pairs
        want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))
        norm = float(adam.clip_global_norm(gs, 1e30))  # the step's table
        gap = abs(norm - want) / want
        limit = 0.5 * want
        gk, gr = [g.clone() for g in gs], [g.clone() for g in gs]
        norm_k = adam.clip_global_norm(gk, limit)  # a table of its own: gk is no step's
        scale = torch.where(norm_k < limit, torch.ones_like(norm_k), limit / norm_k)
        torch._foreach_mul_(gr, scale)
        clip_same = all(torch.equal(x, y) for x, y in zip(gk, gr))
        clip_err = max(float((x - y).abs().max()) for x, y in zip(gk, gr))
        del gk, gr
        log(f"A at {label}'s list ({len(shapes)} tensors, {n / 1e6:.2f} M): A/step bit for "
            f"bit the chain {same} (max abs diff {step_err:.3g}); norm off float64 by "
            f"{gap:.3g} (relative); A/clip at scale {float(scale):.6f} bit for bit the chain's "
            f"scaling by A's norm {clip_same} (max abs diff {clip_err:.3g})")
        check(same and gap <= 1e-6 and clip_same and float(scale) < 1.0,
              f"A at {label}'s list against the chain and float64")

        gc = [g.clone() for g in gs]  # the clip's: a scale of -1 flips signs, nothing drifts
        g_plan = plans.get((None, gc, None, None, None), device)
        partial = torch.empty(g_plan.grid, dtype=torch.float64, device=device)
        out_s, out_c = torch.empty(2, device=device), torch.tensor([1.0, -1.0], device=device)
        sumsq = lambda: lib.colvo_adam_sumsq(*g_plan.args(), partial.data_ptr(),  # noqa: E731
                                             out_s.data_ptr(), 1e30, stream())
        clip = lambda: lib.colvo_adam_clip(*g_plan.args(), out_c.data_ptr(), stream())  # noqa: E731
        step = lambda: adam.adam_update(ps, gs, ms, vs, steps, *args, plans=plans)  # noqa: E731
        plain_step = lambda: adam.step_plain(ps, gs, ms, vs, steps, *args)  # noqa: E731
        fused_ps = [p.detach().clone().requires_grad_(True) for p in ps]
        for p, g in zip(fused_ps, gs):
            p.grad = g
        fused = torch.optim.Adam(fused_ps, lr=lr.clone(), fused=True, capturable=True)
        for key, fn, eager_fn, plain_fn, lib_fn in (
                ("A/sumsq", sumsq, lambda: adam.clip_global_norm(gc, 1e30),
                 lambda: adam.clip_plain(gc, 1e30), None),
                ("A/clip", clip, lambda: adam.clip_global_norm(gc, -want),
                 lambda: adam.clip_plain(gc, -want), None),
                ("A/step", step, step, plain_step, fused.step)):
            rows[f"{key}/{label}"] = dict(
                max_abs_err={"A/sumsq": gap, "A/clip": clip_err, "A/step": step_err}[key],
                ms=timer(fn), cold_ms=cold(fn),
                eager_ms=eager(eager_fn), plain_ms=timer(plain_fn),
                library_ms=timer(lib_fn) if lib_fn else None,
                bound=bound(ADAM_BYTES[key] * n, 0.0),
                registers=ptxas_entry("adam", key[2:].replace("/", "") + "_kernel")[0])
            r = rows[f"{key}/{label}"]
            log(f"{key} at {label}'s list: {r['ms']:.4f} ms (cold {r['cold_ms']:.4f}, eager "
                f"{r['eager_ms']:.4f}; plain chain {r['plain_ms']:.4f}"
                + (f"; fused torch Adam {r['library_ms']:.4f}" if lib_fn else "")
                + f"), bound {r['bound'][0]:.4f} ms ({r['ms'] / r['bound'][0]:.2f}x); "
                f"{r['registers']} registers")
        del ps, gs, gc, ms, vs, fused_ps, fused
        torch.cuda.empty_cache()
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
        check(len(entries) >= {"sampler": 4, "scatter": 1, "project": 3}.get(source, 2),
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
    no-grad loss. Per step, one photometric error per (scale, source): by S
    (``S/grad/C3``; at each scale's own grid under ``loss.photo_native``,
    full resolution otherwise), by F forward and backward under
    ``loss.fused_kernel``, or one grouped S for all under
    ``loss.batched_photo``. And the geo warps of all scales as plane sets
    of one S launch (a launch takes ``sampler.MAX_DESCS`` = 8 sets):
    n_scales sets, 2 × n_scales under ``geo_grad="sym"`` (the reverse
    warps); in the backward one T launch for their source cotangents
    (``T/C1``, or ``T/C1/det`` under ``train.deterministic``), none where
    every sampled source is detached (``geo_stopgrad``, ``sym``). The
    held-out loss makes the value-only launches of one step. The remat
    knobs, ``compute_dtype``, ``scatter_audit``, the per-frame forward and
    the Adam moment's dtype launch nothing of their own (the warp stays
    outside ``photo_remat``'s recomputation). Kernel P projects each grid
    to all its sources in one launch each way (``P/fwd``, ``P/bwd``; the
    held-out loss its forwards): the photometric grid of each scale, the
    geo grid of each scale unless the geo term reuses the photometric one
    (``geo_full_res``; ``photo_native`` without ``geo_res_cap``), and under
    ``geo_grad="sym"`` the reverse warps' grid of each scale. Kernel L
    calibrates each photometric term's warp where LCC is windowed
    (``L/affine``, ``L/gain``; the global step stays plain): once a term,
    once for the whole stack under ``loss.batched_photo``, none where F
    computes LCC itself (``loss.fused_kernel`` with ``affine``), twice in a
    training step under ``loss.photo_remat`` (its recomputation in the
    backward); and under ``loss.lcc_identity`` once for each automask
    identity source. Kernel E computes the SSIM+L1 error of each
    photometric term that F does not (``E/fwd/C3``; the whole stack once
    under ``loss.batched_photo``; twice in a training step under
    ``loss.photo_remat``) with its backward (``E/bwd/C3``), and under
    ``loss.automask`` each identity error (at each scale under
    ``loss.photo_native``) without one. Kernel A clips (``A/sumsq``,
    ``A/clip``) and steps Adam (``A/step``) once a training step."""
    n_scales, n_sources = cfg.model.n_scales, len(cfg.data.frame_offsets)
    pairs = n_scales * n_sources
    grids = n_scales
    if cfg.loss.geometric_weight > 0:
        reuse = cfg.loss.geo_full_res or (cfg.loss.photo_native and cfg.loss.geo_res_cap == 0)
        grids += n_scales * ((not reuse) + (cfg.loss.geo_grad == "sym"))
    counts = {"P/fwd": grids * (n_steps + 1), "P/bwd": grids * n_steps}
    if cfg.loss.geometric_weight > 0:
        sym = cfg.loss.geo_grad == "sym"
        geo_launches = -(-n_scales * (2 if sym else 1) // sampler.MAX_DESCS)
        counts.update({"S/grad/C1": geo_launches * n_steps, "S/value/C1": geo_launches})
        if not (sym or cfg.loss.geo_stopgrad):
            counts["T/C1/det" if cfg.train.deterministic else "T/C1"] = n_steps
    if cfg.loss.fused_kernel:
        counts.update({"F/fwd/C3": pairs * (n_steps + 1), "F/bwd/C3": pairs * n_steps})
    elif cfg.loss.batched_photo:
        counts.update({f"S/grad/C3/g{n_scales}": n_steps, f"S/value/C3/g{n_scales}": 1})
    else:
        counts.update({"S/grad/C3": pairs * n_steps, "S/value/C3": pairs})
    mode = cfg.loss.lcc_mode if cfg.loss.lcc else "off"
    by_f = cfg.loss.fused_kernel and mode in ("affine", "off") and cfg.loss.ssim_alpha > 0
    terms = 0 if by_f else (1 if cfg.loss.batched_photo else pairs)
    per_step = terms * (2 if cfg.loss.photo_remat else 1)
    idents = n_sources * (n_scales if cfg.loss.photo_native else 1) * cfg.loss.automask
    counts["E/fwd/C3"] = per_step * n_steps + terms + idents * (n_steps + 1)
    counts["E/bwd/C3"] = terms * n_steps
    counts.update({"A/sumsq": n_steps, "A/clip": n_steps, "A/step": n_steps})
    key = lcc_key(cfg)
    if key:
        lcc_idents = idents * cfg.loss.lcc_identity
        counts[key] = per_step * n_steps + terms + lcc_idents * (n_steps + 1)
    return {k: v for k, v in counts.items() if v}


def lcc_key(cfg: ColvoConfig):
    """Kernel L's launch counter under ``cfg``'s LCC, or None where LCC has
    no windowed step (off, or ``global`` alone)."""
    mode = cfg.loss.lcc_mode if cfg.loss.lcc else "off"
    mode = mode[len("global+"):] if mode.startswith("global+") else mode
    return f"L/{mode}" if mode in lcc.MODES else None


def eval_hook_launches(cfg: ColvoConfig, calls: int) -> dict:
    """The launches of ``calls`` calls of the training eval hook on one
    model: its forward calibrates each source's warp by L and computes its
    error and its identity error by E (once, and twice, a source a call;
    its captured program's warm-up counts as a call)."""
    if not calls:
        return {}
    n = len(cfg.data.frame_offsets) * (STEP_WARMUP + calls)
    key = lcc_key(cfg)
    return {"E/fwd/C3": 2 * n, **({key: n} if key else {})}


def slice_phase(cfg: ColvoConfig, device, batches, n_steps: int = TRAIN_STEPS,
                captured: bool = False):
    """Train steps at ``cfg``'s size + a held-out no-grad loss on
    ``batches[n_steps]``; returns the state, the metrics by step, the
    launch counts, the median ms/step (CUDA events), the median host time
    of a step call (its dispatch) and, from one more profiled step, the
    device's busy ms and the peak GiB. The steps are eager ``train_step``
    calls, or with ``captured`` replays of ``make_train_step`` (whose first
    call warms up ``STEP_WARMUP`` times and captures)."""
    from colvo_torch.runtime import make_train_step

    state = init_state(cfg, device=device)
    if captured:
        step = make_train_step(state, cfg)
    else:
        step = lambda state_, batch: train_step(state_, batch, cfg)  # noqa: E731

    # Step 1's loss, recomputed with the plain kernels on the same weights.
    with torch.no_grad(), mock.patch.object(sampler, "sample", sampler.sample_plain), \
            mock.patch.object(sampler, "sample_multi", sampler.sample_multi_plain), \
            mock.patch.object(scatter, "scatter", scatter.scatter_plain), \
            mock.patch.object(scatter, "scatter_multi", scatter.scatter_multi_plain), \
            mock.patch.object(fused_loss, "err", fused_loss.err_plain), \
            mock.patch.object(fused_loss, "err_bwd", fused_loss.err_bwd_plain), \
            mock.patch.object(project, "forward", project.project_plain), \
            mock.patch.object(lcc, "forward", lcc_forward_plain), \
            mock.patch.object(ssim, "forward", ssim_forward_plain):
        _, ref_aux = loss_fn(state.model, batches[0], cfg)
    ref_aux = {k: v.item() for k, v in ref_aux.items()}

    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              if device.type == "cuda" else None for _ in range(n_steps)]
    metrics, host_s = [], []
    for i in range(n_steps):
        if events[i]:
            events[i][0].record()
        t0 = time.perf_counter()
        # the caller's copies: a replay overwrites the program's outputs
        metrics.append({k: v.clone() for k, v in step(state, batches[i]).items()})
        host_s.append(time.perf_counter() - t0)
        if events[i]:
            events[i][1].record()
    with torch.no_grad():
        eval_loss, _ = loss_fn(state.model, batches[n_steps], cfg)
    counts = launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    # a replay allocates nothing: the captured step's memory is taken over
    # its first call (warm-up, capture into the graph's pool, replay)
    run_peak = torch.cuda.max_memory_allocated() / 2**30
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
    busy, peak = float("nan"), float("nan")
    if device.type == "cuda":
        busy, peak = profile_step(lambda: step(state, batches[0]))
        if captured:
            peak = run_peak
        med = float(np.median(step_ms[1:]))
        log(f"train step{' (captured)' if captured else ''}: {med:.2f} ms/step (median of "
            f"steps 2..{n_steps}, CUDA events; "
            f"all: {[round(t, 2) for t in step_ms]}); device busy {busy:.2f} ms of it "
            f"({100 * busy / med:.1f} %, kernel time of the profiled step); a step call "
            f"returns after {host_med:.2f} ms on the host clock (median, its dispatch)")
    return state, metrics, counts, med, host_med, (busy, peak)


KNOB_STEPS = 3  # train steps of each knob configuration
# The off-default training configurations of the knob phase: (label,
# {"section.knob": value}, exact). An exact one computes the default's loss
# on the same weights and batch (it changes only gradients, memory,
# launches or what is stored), so its step 1 is held to the default's.
KNOB_PATHS = (
    ("photo_native", {"loss.photo_native": True}, False),
    ("photo_remat", {"loss.photo_remat": True}, True),
    ("geo_full_res", {"loss.geo_full_res": True}, False),
    ("geo_stopgrad", {"loss.geo_stopgrad": True}, True),
    ("geo_grad=sym", {"loss.geo_grad": "sym"}, False),
    ("scatter_audit", {"loss.scatter_audit": True}, True),
    ("compute_dtype=bfloat16", {"loss.compute_dtype": "bfloat16"}, False),
    ("photo_native+fused_kernel", {"loss.photo_native": True, "loss.fused_kernel": True}, False),
    ("batched_photo+compute_dtype", {"loss.batched_photo": True,
                                     "loss.compute_dtype": "bfloat16"}, False),
    ("model.remat", {"model.remat": True}, True),
    ("batched_snippet=false", {"model.batched_snippet": False}, True),
    ("adam_mu_dtype=bfloat16", {"train.adam_mu_dtype": "bfloat16"}, True),
)
# The captured chunk of the knob phase: the memory knobs together.
KNOB_CHUNK = {"model.remat": True, "loss.photo_remat": True, "train.adam_mu_dtype": "bfloat16"}
CHUNK_WARMUP = STEP_WARMUP  # eager chunks (K steps each) a chunk's first call runs first


def knob_config(knobs: dict) -> ColvoConfig:
    cfg = ColvoConfig()
    for key, value in knobs.items():
        section, leaf = key.split(".")
        setattr(getattr(cfg, section), leaf, value)
    return cfg


def knob_phase(device, smi: str, batches, default_first: dict, default_ms: float,
               default_prof: tuple) -> Counter:
    """Each of ``KNOB_PATHS`` at full width from the slice phase's initial
    weights and batches, as a slice run of ``KNOB_STEPS`` steps and a
    held-out loss: finite losses, the exact launch counts, step 1's loss
    terms equal to the plain kernels' (1e-3 relative) and, for the exact
    knobs, to the default path's step 1 (1e-3 relative); ms/step, the
    device's busy ms and the peak GiB beside the default's. Then one
    ``make_scan_train`` chunk of ``CHUNK_K`` steps under ``KNOB_CHUNK``.
    The steps are replays of ``make_train_step``, as ``cli train`` takes
    them: every knob must capture. Returns the phase's kernel launches."""
    t_phase = time.time()
    counts, table = Counter(), []
    for label, knobs, exact in KNOB_PATHS:
        log(f"--- knob: {label} ---")
        cfg = knob_config(knobs)
        state, metrics, path_counts, ms, _, (busy, peak) = slice_phase(
            cfg, device, batches, n_steps=KNOB_STEPS, captured=True)
        # the warm-up's steps, then the captured launches × the replays
        expect = expected_launches(cfg, KNOB_STEPS + STEP_WARMUP)
        check(path_counts == expect, f"{label} launch counts {path_counts} == {expect}")
        counts.update(path_counts)
        if cfg.loss.scatter_audit:
            check(all(m["geo/scatter_overflow"] == 0.0 for m in metrics),
                  "scatter_audit: geo/scatter_overflow is 0 (T drops nothing)")
        if cfg.train.adam_mu_dtype == "bfloat16":
            check(all(st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype ==
                      torch.float32 for st in state.optimizer.state.values()),
                  "adam_mu_dtype: first moments bf16, second float32")
        if exact:
            for k, v in default_first.items():
                check(k == "grad_norm" or abs(metrics[0][k] - v) <= 1e-3 * max(abs(v), 1e-6),
                      f"step 1 {k}: {label} {metrics[0][k]} vs default {v}")
            log(f"step 1, {label} vs default: " + " ".join(
                f"{k} {metrics[0][k]:.6g}/{v:.6g}" for k, v in default_first.items()))
        table.append((label, ms, busy, peak))
        del state
    counts.update(knob_chunk(device, smi))
    log(f"knob phase ({smi}): ms/step (median of replays 2..{KNOB_STEPS}, CUDA events), device "
        f"busy ms of a profiled replay, peak GiB over the steps (the first call's warm-up and "
        f"capture); the default path's eager {default_ms:.2f} / {default_prof[0]:.2f} / "
        f"{default_prof[1]:.2f}")
    for label, ms, busy, peak in table:
        log(f"  knob {label:28s} {ms:8.2f} ms/step  {busy:7.2f} ms busy  {peak:6.2f} GiB")
    log(f"knob phase: {time.time() - t_phase:.1f} s")
    return counts


def knob_chunk(device, smi: str) -> Counter:
    """``make_scan_train`` at ``CHUNK_K`` under ``KNOB_CHUNK`` on a rendered
    corpus: the capture (checkpointed blocks and statistics, the port's
    Adam with its bf16 moment) and one replay, the launches of K steps,
    the indices and step 1's loss terms of one eager step on the same
    draws (``TOL_CHUNK_REL``), bf16 moments; ms/step over replays and the
    peak memory. Returns the launches."""
    from colvo_torch.data import DeviceSnippetStore, device_augment
    from colvo_torch.data.device_store import gather
    from colvo_torch.runtime import make_scan_train

    cfg = knob_config(KNOB_CHUNK)
    ds = synthetic_dataset(cfg.data, n_sequences=2, n_frames=8)
    store = DeviceSnippetStore(ds.sequences, ds.intrinsics, cfg.data.frame_offsets, device=device)
    state, eager_state = init_state(cfg, device=device), init_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
    chunk = make_scan_train(state, cfg, CHUNK_K)
    rng = gen.get_state()
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state, first = chunk(state, store.frames, store.table, store.k, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = Counter(launch_counts())
    want = Counter(expected_launches(cfg, CHUNK_K)) - Counter(expected_launches(cfg, 0))
    # the first call's launches: its eager warm-up chunk and one replay
    warm = Counter(expected_launches(cfg, CHUNK_WARMUP * CHUNK_K)) - Counter(
        expected_launches(cfg, 0))
    check(chunk.graph is not None and state.step == CHUNK_K, "knob chunk: captured K steps")
    check(Counter(chunk.captured_launches) == want and counts == want + warm,
          f"knob chunk: captured {chunk.captured_launches} == {dict(want)}; the first call's "
          f"{dict(counts)} == those + {CHUNK_WARMUP} warm-up chunk's {dict(warm)}")
    check(all(st["exp_avg"].dtype == torch.bfloat16 for st in state.optimizer.state.values()),
          "knob chunk: first moments bf16")
    check(all(bool(torch.isfinite(v).all()) for v in first.values()), "knob chunk metrics finite")
    replay = torch.Generator(device=device)
    replay.set_state(rng)
    idx = torch.randint(0, store.n_snippets, (cfg.data.batch_size,), generator=replay,
                        device=device)
    check(torch.equal(idx, chunk.indices[0]), "knob chunk: step 1 drew the eager step's indices")
    aug, clean = device_augment(gather(store.frames, store.table, idx), replay, cfg.data)
    want1 = {k: v.item() for k, v in train_step(eager_state, {"frames": aug, "frames_clean": clean,
                                                              "k": store.k}, cfg).items()}
    for k, v in want1.items():
        if k != "grad_norm":
            got = first[k][0].item()
            check(abs(got - v) <= TOL_CHUNK_REL * max(abs(v), 1e-6),
                  f"knob chunk step 1 {k}: {got} vs eager {v}")
    del eager_state
    reset_launch_counts()
    step = lambda: chunk(state, store.frames, store.table, store.k, gen)  # noqa: E731
    chunk_ms = _events_ms(step, CHUNK_TIMED) / CHUNK_K
    counts.update(launch_counts())
    log(f"knob chunk ({smi}): K={CHUNK_K} under {KNOB_CHUNK}: {chunk_ms:.2f} ms/step (CUDA events "
        f"over {CHUNK_TIMED} replays); peak {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} held over the capture; step 1 vs eager: " + " ".join(
            f"{k} {first[k][0].item():.6g}/{v:.6g}" for k, v in want1.items()))
    return counts


DET_STEPS = 5  # steps of each deterministic cli train run (the last one profiled)
DET_CKPT = 4  # the step whose checkpoints the two deterministic runs must share bit for bit
DET_CALLS = 20  # calls of the deterministic T that must give the same bits
DET_GLOBAL = (4, (256, 320), (512, 640))  # planes, output and source: the global path
# A fresh process that runs the CLI (``python -m colvo_torch.cli`` does the
# same) with CUDA events around each step of the loop, then prints the
# steps' device-clock ms, its kernel launches and the kinds of step
# function the loop made (``TrainStep``: a captured program).
DET_CHILD = """
import json, sys
import torch
from colvo_torch import cli
from colvo_torch.kernels import launch_counts
from colvo_torch.runtime import loop

events, kinds = [], []
make = loop.make_step_fn


def timed_make(state, cfg):
    step_fn = make(state, cfg)
    kinds.append(type(step_fn).__name__)

    def timed_step(state, batch):
        if not torch.cuda.is_available():
            return step_fn(state, batch)
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = step_fn(state, batch)
        pair[1].record()
        events.append(pair)
        return out
    return timed_step


loop.make_step_fn = timed_make
rc = cli.main(sys.argv[1:])
if events:
    torch.cuda.synchronize()
print("step ms " + json.dumps([a.elapsed_time(b) for a, b in events]), flush=True)
print("launch counts " + json.dumps(launch_counts()), flush=True)
print("step fns " + json.dumps(kinds), flush=True)
sys.exit(rc)
"""


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN matching NaN whatever its payload."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def ptxas_entry(source: str, kernel: str) -> tuple:
    """(registers, static shared bytes) of the entry of ``csrc/<source>.cu``
    whose name holds ``kernel``, from the build's ``ptxas -v`` report."""
    report = build.ptxas_report(source)
    m = re.search(rf"Compiling entry function '\w*{kernel}\w*'.*?Used (\d+) registers"
                  r"(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", report, re.S)
    check(m is not None, f"ptxas report of {source}.cu lists {kernel}")
    return int(m.group(1)), int(m.group(2) or 0)


def det_geo_sets(device, gen) -> list:
    """The deterministic phase's plane sets at the geo shapes: (x, y, g,
    source size) a scale, g drawn from ``gen`` and 0 on its top eighth."""
    sets = []
    for i, (gh, gw) in enumerate(GEO_SCALES):
        gx, gy = make_coords(GEO_N, gh, gw, 50 + i, device)
        g = torch.randn((GEO_N, 1, gh, gw), generator=gen).to(device)
        g[:, :, : gh // 8] = 0.0
        sets.append((gx, gy, g, (gh, gw)))
    return sets


def det_rows(device, gen, timer, eager) -> dict:
    """P5/det: T's deterministic variant, bit for bit the plain fixed-point
    version (``scatter_multi_plain_fixed``, run on the card) at the geo
    shapes (the four scales in one launch of the cluster kernel), under the
    wild warp at the two largest, at ``GEO_ODD`` and on ``DET_GLOBAL``,
    planes too large for a cluster (the global path, ``T/C1/det/global``);
    ``DET_CALLS`` calls of each give the same bits, within
    ``TOL_SCATTER_REL`` of max|d_src| of the float plain version; a NaN
    cotangent makes its plane NaN. Timed beside the float T on the same
    inputs; the library call is one deterministic ``index_add_`` of every
    tap's term (indices and terms made outside the clock), timed eagerly.
    The row also gets the cluster kernel's registers and shared memory
    (``ptxas -v`` and the plan) and its cluster size."""
    geo, wild, odd, big = det_geo_sets(device, gen), [], [], []
    for gh, gw in GEO_SCALES[:2]:
        wx = (torch.rand((GEO_N, gh, gw), generator=gen) * (gw + 2) - 1).to(device)
        wy = (torch.rand((GEO_N, gh, gw), generator=gen) * (gh + 2) - 1).to(device)
        wild.append((wx, wy, torch.randn((GEO_N, 1, gh, gw), generator=gen).to(device), (gh, gw)))
    oh, ow = GEO_ODD
    odd.append((*make_coords(GEO_N, oh, ow, 60, device),
                torch.randn((GEO_N, 1, oh, ow), generator=gen).to(device), (oh, ow)))
    n, (h, w), (hs, ws) = DET_GLOBAL
    bx, by = make_coords(n, h, w, 61, device)
    big.append((bx * (ws / w), by * (hs / h), torch.randn((n, 1, h, w), generator=gen).to(device),
                (hs, ws)))
    err, rel, on_card = 0.0, 0.0, device.type == "cuda"
    prev = torch.are_deterministic_algorithms_enabled()
    for label, sets, key in (("geo", geo, "T/C1/det"), ("wild", wild, "T/C1/det"),
                             (f"{oh}x{ow}", odd, "T/C1/det"),
                             ("global", big, "T/C1/det/global")):
        xs, ys, gs, hws = (list(t) for t in zip(*sets))
        fixed = scatter.scatter_multi_plain_fixed(xs, ys, gs, hws)
        reset_launch_counts()
        torch.use_deterministic_algorithms(True)
        try:
            first = [d.clone() for d in scatter.scatter_multi(xs, ys, gs, hws)]
            for _ in range(DET_CALLS - 1):
                again = scatter.scatter_multi(xs, ys, gs, hws)
                check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                          for a, b in zip(again, first)),
                      f"deterministic T gives the same bits on every call ({label})")
        finally:
            torch.use_deterministic_algorithms(prev)
        # (a rehearsal on the CPU launches no kernel and runs the float plain version)
        check(not on_card or launch_counts() == {key: DET_CALLS},
              f"deterministic T ({label}) launches {launch_counts()} == {{{key}: {DET_CALLS}}}")
        check(not on_card or all(same_bits(a, b) for a, b in zip(first, fixed)),
              f"deterministic T ({label}) bit for bit the plain fixed-point version")
        for d, want in zip(first, scatter.scatter_multi_plain(xs, ys, gs, hws)):
            check(bool(torch.isfinite(d).all()), "deterministic T finite")
            e = (d - want).abs().max().item()
            err, rel = max(err, e), max(rel, e / want.abs().max().item())
    check(rel <= TOL_SCATTER_REL, f"deterministic T vs plain: {rel:.3g} of max|d_src|")
    xs, ys, gs, hws = (list(t) for t in zip(*geo))
    nan_g = [g.clone() for g in gs]
    nan_g[0][0, 0, -1, -1] = float("nan")
    torch.use_deterministic_algorithms(True)
    try:
        nan_out = scatter.scatter_multi(xs, ys, nan_g, hws)
        call = lambda: scatter.scatter_multi(xs, ys, gs, hws)  # noqa: E731
        det_ms, det_eager = timer(call), eager(call)
        b_xs, b_ys, b_gs, b_hws = (list(t) for t in zip(*big))
        global_ms = timer(lambda: scatter.scatter_multi(b_xs, b_ys, b_gs, b_hws))
    finally:
        torch.use_deterministic_algorithms(prev)
    # the kernel's plane is NaN in every cell (the plain version's, on a
    # CPU rehearsal, where the NaN term lands)
    nan_plane = torch.isnan(nan_out[0][0])
    check(bool((nan_plane.all() if on_card else nan_plane.any())
               and torch.isfinite(nan_out[0][1:]).all()),
          "deterministic T: a NaN cotangent makes its plane NaN, and only it")
    # one index_add_ of every tap's term: the single deterministic PyTorch
    # call that computes T's function
    idx, val, off = [], [], 0
    for x, y, g, (h, w) in geo:
        x0, x1, wx = bilinear_taps(x, w)
        y0, y1, wy = bilinear_taps(y, h)
        base = off + (torch.arange(g.shape[0], device=device) * (h * w)).reshape(-1, 1, 1)
        for yy, xx, wt in ((y0, x0, (1 - wx) * (1 - wy)), (y0, x1, wx * (1 - wy)),
                           (y1, x0, (1 - wx) * wy), (y1, x1, wx * wy)):
            idx.append((base + yy * w + xx).reshape(-1))
            val.append((g[:, 0] * wt).reshape(-1))
        off += g.shape[0] * h * w
    idx, val = torch.cat(idx), torch.cat(val)
    flat = torch.zeros(off, device=device)
    torch.use_deterministic_algorithms(True)
    try:
        lib_ms = eager(lambda: flat.zero_().index_add_(0, idx, val))
    finally:
        torch.use_deterministic_algorithms(prev)
    float_ms = timer(call)
    gpx = sum(x.numel() for x, _, _, _ in geo)
    gsrc = sum(g.shape[0] * h * w for _, _, g, (h, w) in geo)
    extra = {}
    if on_card:
        plan = scatter.det_plan(scatter._lib(), scatter.multi_params(xs, ys, gs, hws)[0])
        regs, static_smem = ptxas_entry("scatter", "scatter_det_cluster_kernel")
        extra = dict(registers=regs, smem_bytes=plan.smem_bytes + static_smem,
                     cluster=plan.cluster)
        log(f"T deterministic cluster kernel: {regs} registers, {plan.smem_bytes} B of dynamic "
            f"shared memory a CTA (+{static_smem} static), clusters of {plan.cluster} CTAs, CTAs "
            f"a plane by scale {list(plan.parts)}; cudaOccupancyMaxActiveClusters "
            f"{scatter.det_occupancy(plan.smem_bytes)}")
        for label, split in (("the geo shapes", det_split(scatter, device)),
                             (f"{n}x{hs}x{ws}", det_split(scatter, device, big))):
            log(f"T deterministic at {label}, device time by operation (torch.profiler over "
                f"20 calls, each operation once a call; us a launch, launches recorded): "
                + ", ".join(f"{name[:60]} {us:.2f} ({seen})" for name, (us, seen) in split.items())
                + f"; sum {sum(us for us, _ in split.values()):.2f}")
    log(f"T deterministic at the four geo scales, under the wild warp, at {oh}x{ow} and on "
        f"{n} planes of {hs}x{ws} (the global path): {DET_CALLS} calls bit for bit, and bit for "
        f"bit the plain fixed-point version; |d_src| {err:.3g}, / max|d_src| {rel:.3g}; "
        f"{det_ms:.4f} ms (eager {det_eager:.4f}) against the float T's {float_ms:.4f} ms on the "
        f"same inputs; the global path {global_ms:.4f} ms at {n}x{hs}x{ws}; one deterministic "
        f"index_add_ {lib_ms:.4f} ms (eager)")
    return {"P5/det": dict(
        max_abs_err=err, ms=det_ms, eager_ms=det_eager, float_ms=float_ms,
        plain_ms=timer(lambda: scatter.scatter_multi_plain_fixed(xs, ys, gs, hws)),
        library_ms=lib_ms, bound=bound(4 * (3 * gpx + gsrc), 24 * gpx), **extra)}


def det_split(scatter_module, device, sets=None, calls: int = 20) -> dict:
    """The device time of each operation (kernels, memsets and fills by
    name) of a deterministic ``scatter_module.scatter_multi`` call on
    ``sets`` (default: ``det_rows``'s geo shapes), by ``torch.profiler``
    over ``calls`` calls: name → (µs a launch, the mean over the launches
    it recorded; launches it recorded). The profiler can miss launches, so
    the mean is taken over those it saw. It needs only ``scatter_multi``,
    so it also measures another tree's module: PERF.md names the command."""
    from torch.profiler import ProfilerActivity, profile

    if sets is None:
        sets = det_geo_sets(device, torch.Generator(device="cpu").manual_seed(5))
    xs, ys, gs, hws = (list(t) for t in zip(*sets))
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        scatter_module.scatter_multi(xs, ys, gs, hws)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                scatter_module.scatter_multi(xs, ys, gs, hws)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    us, seen = Counter(), Counter()
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            us[evt.name] += evt.device_time_total
            seen[evt.name] += 1
    return {name: (us[name] / seen[name], seen[name]) for name in us}


def det_phase(device, smi: str) -> tuple:
    """The deterministic phase: T's deterministic variant (``det_rows``),
    then ``det_cli_runs``. Returns the kernel rows, the runs' launches and
    the step-``DET_CKPT`` checkpoint they share."""
    t_phase = time.time()
    rows = det_rows(device, torch.Generator(device="cpu").manual_seed(5), time_ms, eager_ms)
    counts, ckpt = det_cli_runs(device, smi)
    log(f"deterministic phase: {time.time() - t_phase:.1f} s")
    return rows, counts, ckpt


def run_child(cmd, what: str) -> str:
    """Run ``cmd`` from the repository root to its end (killed after 600
    s); fails unless it exits 0. Returns its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n" + out[-3000:])
    return out


def child_step_ms(out: str) -> tuple:
    """``DET_CHILD``'s printed step times and launch counts; fails unless
    its loop took the captured step (one ``TrainStep``)."""
    kinds = json.loads(out.rsplit("step fns ", 1)[1].splitlines()[0])
    check(kinds == ["TrainStep"], f"the loop's step functions {kinds} are one captured step")
    step_ms = json.loads(out.rsplit("step ms ", 1)[1].splitlines()[0])
    return step_ms, json.loads(out.rsplit("launch counts ", 1)[1].splitlines()[0])


def flat_checkpoint(path: str) -> dict:
    return dict(_flat_items(torch.load(path, map_location="cpu", weights_only=True)))


def same_checkpoint(a: dict, b: dict) -> bool:
    """Two ``flat_checkpoint``s equal bit for bit."""
    return a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k] for k, v in a.items())


def det_cli_runs(device, smi: str, extra_args=()) -> tuple:
    """Two fresh processes of ``cli train --train.deterministic=true``, one
    after the other (so that each step's time is its own), each
    ``DET_STEPS`` steps at full width (``extra_args`` may add overrides) on
    the same synthetic data and seed: both exit 0, launch exactly a train
    step's kernels with ``T/C1/det`` for T, log the same losses, and write
    step-``DET_CKPT`` checkpoints equal bit for bit (model, Adam moments and
    step counts). Then a third fresh process of the default (not
    deterministic) step with the same arguments. Each prints its ms/step
    (CUDA events, median of steps 2-4) and the device busy ms of its last
    step (``torch.profiler``). Returns the runs' launches and the shared
    checkpoint (``flat_checkpoint``)."""
    cfg = ColvoConfig().apply_overrides([a for a in extra_args if a.startswith("--")])
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs, timing = [], []
        for run, det in enumerate((True, True, False)):
            d = os.path.join(tmp, f"run{run}")
            cmd = [sys.executable, "-c", DET_CHILD, *det_cli_args(d, det, device), *extra_args]
            t0 = time.time()
            out = run_child(cmd, f"{'deterministic' if det else 'default'} cli train")
            outs.append(out)
            cfg.train.deterministic = det
            want = step_launches(cfg, DET_STEPS + STEP_WARMUP)
            step_ms, got = child_step_ms(out)
            # (a rehearsal on the CPU launches no kernel)
            check(got == want or device.type == "cpu", f"run {run} launches {got} == {want}")
            counts.update(got)
            busy = float("nan")
            if device.type == "cuda":
                busy = trace_busy(os.path.join(
                    d, "log", f"trace_steps_{DET_STEPS - 1}_{DET_STEPS}.json"))[0]
            med = float(np.median(step_ms[1:DET_STEPS - 1])) if step_ms else float("nan")
            timing.append((time.time() - t0, med, busy, step_ms))
        flat = [flat_checkpoint(os.path.join(tmp, f"run{r}", "ckpt", str(DET_CKPT), "state.pt"))
                for r in range(2)]
        check(same_checkpoint(flat[0], flat[1]),
              f"the two deterministic runs' step-{DET_CKPT} checkpoints are equal bit for bit")
        rows_log = [[json.loads(line) for line in open(os.path.join(tmp, f"run{r}", "log",
                                                                    "metrics.jsonl"))]
                    for r in range(2)]
        losses = [[(row["step"], row["loss/total"]) for row in rl if "loss/total" in row]
                  for rl in rows_log]
        check(losses[0] == losses[1] and losses[0], f"the two runs log the same losses {losses}")
        n_tensors = sum(isinstance(v, torch.Tensor) for v in flat[0].values())
        log(f"deterministic cli train ({smi}): two fresh processes, {DET_STEPS} steps each; "
            f"their step-{DET_CKPT} checkpoints equal bit for bit ({n_tensors} tensors: weights, "
            f"Adam moments, step counts); losses {losses[0]}")
        for label, (wall, med, busy, step_ms) in zip(
                ("deterministic run 1", "deterministic run 2", "default run"), timing):
            log(f"{label} ({smi}): {wall:.1f} s in all; {med:.2f} ms/step (CUDA events, median "
                f"of steps 2-{DET_STEPS - 1}; all {[round(t, 2) for t in step_ms]}); device busy "
                f"{busy:.2f} ms in step {DET_STEPS} (torch.profiler)")
    return counts, flat[0]


def det_cli_args(d: str, det: bool, device) -> list:
    """``cli train``'s arguments of a deterministic-phase run in ``d``."""
    return ["train", "--max-steps", str(DET_STEPS), "--log-dir", os.path.join(d, "log"),
            f"--train.ckpt_dir={d}/ckpt", f"--train.ckpt_every_steps={DET_CKPT}",
            f"--train.profile_steps={DET_STEPS - 1}:{DET_STEPS}",
            f"--train.deterministic={'true' if det else 'false'}", "--device", device.type]


def step_launches(cfg: ColvoConfig, n_steps: int) -> dict:
    """The kernel launches of ``n_steps`` train steps without the held-out loss."""
    return dict(Counter(expected_launches(cfg, n_steps)) - Counter(expected_launches(cfg, 0)))


def _flat_items(obj, prefix=""):
    """(dotted key, leaf) pairs of a nested checkpoint payload."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat_items(v, f"{prefix}{k}.")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat_items(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), obj


# Kernel-name keywords of the buckets in the step breakdown, first match wins.
BUCKETS = (
    ("S (bilinear_sample)", ("bilinear_sample",)),
    ("F (fused_err)", ("fused_err",)),
    ("T (bilinear_scatter)", ("bilinear_scatter",)),
    ("P (project_depth)", ("project_depth",)),
    ("L (lcc_window)", ("lcc_window",)),
    ("E (ssim_err)", ("ssim_err",)),
    ("conv / gemm", ("conv", "gemm", "xmma", "cutlass", "sm90", "wgrad", "dgrad", "fprop")),
    ("norm", ("norm",)),
    ("pooling", ("pool",)),
    ("reduce", ("reduce",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / fill", ("copy", "memcpy", "memset", "fill", "cat")),
)


def profile_step(step) -> tuple:
    """One more train step, ``step()``, under ``torch.profiler``: device time by kernel,
    by bucket and by ATen op and input shapes, the device's busy share of
    the step, peak memory. Returns the device's kernel time in ms and the
    step's peak memory in GiB."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        step()
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
        return busy, peak_gib
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
    return busy, peak_gib


# Where a convolution's kernels show in a profile: the ATen op that
# launches them and the index of its weight among the op's inputs (the
# input is the first 4-D input before it).
CONV_OPS = {"aten::cudnn_convolution": 1, "aten::convolution_backward": 2,
            "aten::_conv_depthwise2d": 1, "aten::_convolution": 1, "aten::convolution": 1}


def conv_split(prof) -> tuple:
    """({kernel name: ms} launched by depthwise convolutions, {kernel name:
    ms} launched by every other op) of a profile taken with
    ``record_shapes``: a convolution is depthwise where its weight is
    (C, 1, k, k) over an input of C channels."""
    dw, rest = Counter(), Counter()
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU or not evt.kernels:
            continue
        shapes = evt.input_shapes or []
        at = CONV_OPS.get(evt.name)
        depthwise = False
        if at is not None and len(shapes) > at and len(shapes[at]) == 4:
            w = shapes[at]
            x = next((s for s in shapes[:at] if len(s) == 4), None)
            depthwise = w[1] == 1 and x is not None and x[1] == w[0] > 1
        for k in evt.kernels:
            (dw if depthwise else rest)[k.name] += k.duration / 1e3
    return dw, rest


def profiled_conv_split(step) -> tuple:
    """``conv_split`` of one more eager ``step()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    return conv_split(prof)


def mpvit_phase(device, batch) -> Counter:
    """A default step of the MPViT depth net (``model.depth_net="mpvit_s"``,
    the default config otherwise: B=12, 256×320, four scales, DCDP, bf16)
    with the launch counters reset just before it: 38 ``FA/fwd``, 38
    ``FA/bwd``, and the loss's kernels a ResNet step launches. Then one
    more step of it and one of the ResNet net under the profiler: the
    kernels that the benchmark's ``dwconv_ms.mpvit`` counts
    (``flops_mpvit.kernel_kind`` "dwconv") are launched by MPViT's
    depthwise convolutions and by no other op in either step. Logs the
    depthwise convolutions' ms a step by kernel, the share the reader
    counts, and the ResNet step's kernels that a looser rule would take."""
    from portbench import flops_mpvit

    cfg = ColvoConfig()
    cfg.model.depth_net = "mpvit_s"
    state = init_state(cfg, seed=0, device=device)
    reset_launch_counts()
    train_step(state, batch, cfg)
    torch.cuda.synchronize()
    counts = Counter(launch_counts())
    expect = dict(step_launches(cfg, 1), **{"FA/fwd": 38, "FA/bwd": 38})
    check(dict(counts) == expect, f"MPViT step launch counts {dict(counts)} == {expect}")
    log(f"MPViT step: launches {dict(sorted(counts.items()))}")
    dw, rest = profiled_conv_split(lambda: train_step(state, batch, cfg))
    del state
    resnet = ColvoConfig()
    state = init_state(resnet, seed=0, device=device)
    train_step(state, batch, resnet)
    _, resnet_rest = profiled_conv_split(lambda: train_step(state, batch, resnet))
    del state
    counted = {k: ms for k, ms in dw.items() if flops_mpvit.kernel_kind(k) == "dwconv"}
    log(f"MPViT step: depthwise convolutions {sum(dw.values()):.3f} ms on the device, of which "
        f"dwconv_ms.mpvit counts {sum(counted.values()):.3f} ms; by kernel: " + "; ".join(
            f"{ms:.3f} ms {'counted' if k in counted else 'not counted'} {k[:90]}"
            for k, ms in dw.most_common()))
    for label, other in (("MPViT", rest), ("ResNet", resnet_rest)):
        wrong = {k: ms for k, ms in other.items() if flops_mpvit.kernel_kind(k) == "dwconv"}
        check(not wrong, f"dwconv_ms.mpvit counts kernels of the {label} step's other ops: "
              f"{wrong}")
        grouped = {k[:90]: round(ms, 3) for k, ms in other.items() if "grouped" in k}
        log(f"{label} step: other ops' kernels named 'grouped' (not counted): {grouped}")
    return counts


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


def vo_phase(cfg: ColvoConfig, state, device, smi: str, timed: bool = True) -> tuple:
    """Streaming VO on the trained weights at ``cfg``'s size: run_vo over a
    rendered sequence, its checks against per-pair serving, across wires
    and input formats and with symmetric pose, the evaluation on top
    (ATE/RPE, polyps, stitched cloud, PLY), and its times. No kernel of
    the training path may launch. Returns frames/s by mode (none unless
    ``timed``, which needs a CUDA device) and ``refine_keyframe_poses``'
    arguments on the run_vo result (a keyframe a frame; uint8 frames)."""
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
    refine_inputs = {"poses": vo.poses, "keyframe_ids": vo.keyframe_ids, "depths": vo.depths,
                     "frames_kf": u8[vo.keyframe_ids], "k": seq.k}

    if not timed:
        return {}, refine_inputs
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
    return fps, refine_inputs


def vo_stage_times(runner, frames, rel6, smi: str) -> None:
    """The layers of one chunk (rgb uint8 in, float16 wire out): H2D from
    pinned memory, the chunk step (its body eager, and the program's
    replays), D2H of the wire into pinned memory (CUDA events), the host
    decode and the native chain of the whole sequence (host clock)."""
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
        step_eager = eager_ms(lambda: sv.chunk_body(ci, cb, dev))
        step_graph = eager_ms(lambda: sv.chunk_step(ci, cb, dev))
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
        f"MiB, CUDA events); chunk step {step_eager:.3f} ms eager, {step_graph:.3f} ms a replay "
        f"of its program (CUDA events); D2H {d2h:.4f} ms ({wire.numel() / 2**20:.2f} MiB wire); "
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
    """Decode a PNG file with the port's codec; returns its array's shape."""
    from colvo_torch.data.png import read_png

    return read_png(path).shape


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
    and each step call's host time are taken during run 1, and
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
    runs, datasets, producer_s, calls, kinds = [], [], [], [], []
    real_train = pipelines.train_loop

    def recording(cfg_, dataset, **kwargs):
        datasets.append(dataset)
        out = real_train(cfg_, dataset, **kwargs)
        runs.append(out[1])
        return out

    def timed(step_fn):
        kinds.append(type(step_fn).__name__)

        def timed_step(*args):
            t0 = time.perf_counter()
            out = step_fn(*args)
            calls.append((t0, time.perf_counter()))
            return out
        return timed_step

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
                wrap_step_fns(timed):
            check(cli.main(["train", "--max-steps", str(LOOP_STEPS),
                            "--train.profile_steps={}:{}".format(*LOOP_PROFILE)] + common) == 0,
                  "cli train, run 1")
        run1_s = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(kinds == ["TrainStep"], f"run 1's steps are replays of one captured step: {kinds}")
        # the warm-up's step, then the captured step's launches × the replays,
        # and the eval hook's call at step 7
        per_step = Counter(expected_launches(cfg, LOOP_STEPS + STEP_WARMUP)) - Counter(
            expected_launches(cfg, 0)) + Counter(eval_hook_launches(cfg, 1))
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
    log(f"loop: a step call (a replay) returned after {np.median(dispatch[1:]):.2f} ms on the "
        f"host clock in run 1 (median of steps 2-{LOOP_STEPS}; the first, with its warm-up and "
        f"capture, {dispatch[0]:.1f}; an eager train_step in the slice {slice_dispatch_ms:.2f}); "
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

        def counted(step_fn):
            def step(state, batch):
                calls.append(state.step + 1)
                return step_fn(state, batch)
            return step

        ds = SnippetDataset([poisoned], [seq.k], cfg.data.frame_offsets)
        raised = None
        try:
            with wrap_step_fns(counted):
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
    run 1's, the interval between step calls, the card's busy
    share over the profiled window, peak memory and the store's upload.
    Returns its launches."""
    from colvo_torch import cli, pipelines
    from colvo_torch.runtime import loop as loop_mod

    cfg = ColvoConfig()
    runs, calls, uploads, kinds = [], [], [], []
    real_train, real_store = pipelines.train_loop, loop_mod.DeviceSnippetStore

    def recording(cfg_, dataset_, **kwargs):
        out = real_train(cfg_, dataset_, **kwargs)
        runs.append(out[1])
        return out

    def timed(step_fn):
        kinds.append(type(step_fn).__name__)

        def timed_step(*args):
            t0 = time.perf_counter()
            out = step_fn(*args)
            calls.append((t0, time.perf_counter()))
            return out
        return timed_step

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
            wrap_step_fns(timed), \
            mock.patch.object(loop_mod, "DeviceSnippetStore", timed_store):
        log_dir, ckpt_dir = os.path.join(tmp, "log"), os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0, phase_ns = time.time(), time.perf_counter_ns()
        check(cli.main(["train", "--max-steps", str(LOOP_STEPS), "--data.loader=device",
                        "--train.profile_steps={}:{}".format(*LOOP_PROFILE)] + LOOP_ARGS
                       + ["--log-dir", log_dir, f"--train.ckpt_dir={ckpt_dir}",
                          "--device", device.type]) == 0, "cli train --data.loader=device")
        run_s = time.time() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(kinds == ["TrainStep"], f"the device loader's steps are replays: {kinds}")
        per_step = Counter(expected_launches(cfg, LOOP_STEPS + STEP_WARMUP)) - Counter(
            expected_launches(cfg, 0)) + Counter(eval_hook_launches(cfg, 1))
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
    log(f"device loader: one step call started every {np.median(gaps):.2f} ms (median; "
        f"all {[round(g, 1) for g in gaps]}), a call returned after {np.median(dispatch[1:]):.2f} "
        f"ms on the host clock (median of steps 2-{LOOP_STEPS}; the slice's "
        f"{slice_dispatch_ms:.2f}); the card busy {busy:.2f} ms of the {window:.2f} ms profiled "
        "window (steps {}-{}, {:.1f} %); peak memory {:.2f} GiB".format(
            *LOOP_PROFILE, 100 * busy / window, peak))
    log("device loader: the host over the profiled window: " + host)
    log(f"device loader: the eval hook at step 7 (its first call: the forward's warm-up, "
        f"capture and replay) took {hook_split(eval_calls(phase_ns)[0])}")
    return counts


def eval_calls(since_ns: int) -> list:
    """The eval hook's calls begun since ``since_ns`` (``perf_counter_ns``), in
    order: each its parts' ms, from its spans (``eval.queue``, ``eval.forward``,
    ``eval.metrics``, ``eval.panels``) keyed ``queue`` ... ``panels``."""
    calls = []
    for s in spans.snapshot().spans:
        if s.start_ns < since_ns or not s.name.startswith("eval."):
            continue
        if s.name == "eval.queue":
            calls.append({})
        calls[-1][s.name[len("eval."):]] = s.ms
    return calls


def hook_split(times: dict) -> str:
    """The eval hook's call split into its parts (host clock)."""
    return (f"{sum(times.values()):.1f} ms: waiting for the queued work {times['queue']:.1f}, "
            f"forward {times['forward']:.1f} (the program's call and the outputs' copy to the "
            f"host), host metrics {times['metrics']:.1f}, panel writes {times['panels']:.1f}")


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


SERVE_FRAMES, SERVE_SEED = 64, 999  # the VO phase's sequence, as files
SERVE_BIG = (432, 540)  # a second frame dir that the area resize brings down by 1.6875
SERVE_BENCH = 24  # frames a benchmark sequence (the sequence's first and second 24)
SERVE_MIN_READ_FPS = 30.0  # reading 256×320 PNG frames: at least the video rate
TOL_NONE_CPU_REL = 1e-4  # norm="none" f32 forward, card against CPU, of the max
# metrics.json of evaluate_synthetic: the depth metrics, ATE/RPE at deltas 1
# and 5 (48 frames), the three polyp errors and their mean (the CPU tests
# hold these keys equal to the reference's)
EVAL_POSE_KEYS = ("ate", "rpe_trans", "rpe_rot_deg", "rpe_trans_5", "rpe_rot_deg_5")
EVAL_POLYP_KEYS = ("polyp/e1", "polyp/e2", "polyp/e3", "polyp/e_mean")


def family_checkpoint(seed: int = 0) -> dict:
    """A synthetic family checkpoint: the state dicts of a torchvision
    ResNet-18 (3- and 6-channel, with its ``fc`` head), a Monodepth2 depth
    decoder and a Monodepth2 pose decoder (K=2), random weights and random
    BatchNorm statistics, under the family's keys."""
    g = torch.Generator().manual_seed(seed)

    def conv(sd, name, cout, cin, k, bias=False):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=g) * (2.0 / (cin * k * k)) ** 0.5
        if bias:
            sd[f"{name}.bias"] = 0.05 * torch.randn(cout, generator=g)

    def bn(sd, name, c):
        sd[f"{name}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.bias"] = 0.2 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = 0.3 * torch.randn(c, generator=g)
        sd[f"{name}.running_var"] = 2 * torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(100)

    def resnet18(cin):
        sd = {}
        conv(sd, "conv1", 64, cin, 7)
        bn(sd, "bn1", 64)
        cin = 64
        for li, width in enumerate((64, 128, 256, 512)):
            for bi in range(2):
                t = f"layer{li + 1}.{bi}"
                conv(sd, f"{t}.conv1", width, cin, 3)
                bn(sd, f"{t}.bn1", width)
                conv(sd, f"{t}.conv2", width, width, 3)
                bn(sd, f"{t}.bn2", width)
                if cin != width:
                    conv(sd, f"{t}.downsample.0", width, cin, 1)
                    bn(sd, f"{t}.downsample.1", width)
                cin = width
        sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=g), torch.zeros(1000)
        return sd

    enc, dec = (64, 64, 128, 256, 512), (16, 32, 64, 128, 256)
    depth, cin, n = {}, enc[-1], 0
    for i in range(4, -1, -1):
        conv(depth, f"decoder.{n}.conv.conv", dec[i], cin, 3, bias=True)
        cin = dec[i] + (enc[i - 1] if i > 0 else 0)
        conv(depth, f"decoder.{n + 1}.conv.conv", dec[i], cin, 3, bias=True)
        cin, n = dec[i], n + 2
    for s in range(4):
        conv(depth, f"decoder.{10 + s}.conv", 1, dec[s], 3, bias=True)
    pose = {}
    for i, (cout, cin_, k) in enumerate(((256, 512, 1), (256, 256, 3), (256, 256, 3), (12, 256, 1))):
        conv(pose, f"net.{i}", cout, cin_, k, bias=True)
    return {"encoder": resnet18(3), "depth": depth, "pose_encoder": resnet18(6), "pose": pose}


def _rot_to_quat(r: np.ndarray) -> tuple:
    """A rotation matrix → its unit quaternion (x, y, z, w) (Shepperd)."""
    t = np.trace(r)
    if t > 0:
        s = 2 * np.sqrt(t + 1)
        return (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, s / 4
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2 * np.sqrt(1 + r[i, i] - r[j, j] - r[k, k])
    q = np.empty(4)
    q[i], q[j], q[k] = s / 4, (r[j, i] + r[i, j]) / s, (r[k, i] + r[i, k]) / s
    q[3] = (r[k, j] - r[j, k]) / s
    return tuple(q)


def write_benchmark(root: str, seq, write_png) -> dict:
    """Two sequences of the rendered ``seq`` in the benchmark layout:
    ``seq_a`` (frames 0..23) with .npy depth, KITTI 3×4 poses and 9-float K;
    ``seq_b`` (frames 24..47) with 16-bit PNG depth and ``depth_scale.txt``,
    TUM poses and 4-float K. Returns each one's rendered frames, depths and
    poses, and its depth PNG's scale (0 for .npy)."""
    gt = {}
    for n, name in enumerate(("seq_a", "seq_b")):
        sl = slice(n * SERVE_BENCH, (n + 1) * SERVE_BENCH)
        frames, depths, poses = seq.frames[sl], seq.depths[sl], seq.poses[sl].astype(np.float64)
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "depth"))
        scale = float(depths.max()) / 65535.0
        for i, (f, z) in enumerate(zip(frames, depths)):
            write_png(os.path.join(d, "rgb", f"{i:06d}.png"),
                      np.clip(f * 255 + 0.5, 0, 255).astype(np.uint8))
            if n == 0:
                np.save(os.path.join(d, "depth", f"{i:06d}.npy"), z)
            else:
                write_png(os.path.join(d, "depth", f"{i:06d}.png"),
                          np.clip(z / scale, 0, 65535).astype(np.uint16))
        k = seq.k.astype(np.float64)
        if n == 0:
            np.savetxt(os.path.join(d, "poses.txt"), poses[:, :3, :].reshape(-1, 12))
            np.savetxt(os.path.join(d, "intrinsics.txt"), k.reshape(-1))
        else:
            rows = [[i, *p[:3, 3], *_rot_to_quat(p[:3, :3])] for i, p in enumerate(poses)]
            np.savetxt(os.path.join(d, "poses.txt"), rows)
            np.savetxt(os.path.join(d, "depth_scale.txt"), [scale])
            np.savetxt(os.path.join(d, "intrinsics.txt"), [k[0, 0], k[1, 1], k[0, 2], k[1, 2]])
        gt[name] = (frames, depths, poses, scale if n else 0.0)
    return gt


class _TimedSource:
    """A frame source whose reading (``list(src)``) is timed into ``times``."""

    def __init__(self, src, times: Counter):
        self.src, self.times = src, times

    def __len__(self):
        return len(self.src)

    def __iter__(self):
        t0 = time.perf_counter()
        frames = list(self.src)
        self.times["read"] += time.perf_counter() - t0
        return iter(frames)


def _timed(fn, times: Counter, key: str):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times[key] += time.perf_counter() - t0
        return out
    return run


def serving_cli_phase(device, smi: str, weights: dict) -> None:
    """The serving CLI end to end, in process through ``colvo_torch.cli``
    at full width on the card, on files: ``infer`` on a 256×320 PNG frame
    dir, ``vo`` on a 432×540 one (the area resize), ``recon``, ``viz``,
    ``eval`` on a rendered sequence and on a two-sequence benchmark dir,
    ``import-torch`` of a synthetic family checkpoint and ``vo`` and
    ``eval --data`` on its ``norm="none"`` weights. No S, T or F launch. Prints
    the codec's and the resize's ms a frame, the commands' frames/s, the
    layers of ``vo``, its busy share and peak memory."""
    from colvo_torch import cli, pipelines
    from colvo_torch.config import ModelConfig
    from colvo_torch.data import render_sequence
    from colvo_torch.data.benchmark import load_benchmark_sequence
    from colvo_torch.data.png import read_png, write_png
    from colvo_torch.data.sources import FrameDirSource, _resize, rgb_to_i420_cv2
    from colvo_torch.evaluation import DEPTH_METRIC_NAMES
    from colvo_torch.runtime import export_npz, load_npz
    from colvo_torch.vo import load_ply

    t_phase = time.time()
    dev = ["--device", device.type]
    cfg = ColvoConfig()
    h, w = cfg.data.height, cfg.data.width
    seq = render_sequence(n_frames=SERVE_FRAMES, height=h, width=w, seed=SERVE_SEED)
    u8 = np.clip(seq.frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    render_s = time.time() - t_phase
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        small, big = os.path.join(tmp, "frames_256"), os.path.join(tmp, "frames_432")
        os.makedirs(small)
        os.makedirs(big)
        t0 = time.perf_counter()
        for i, f in enumerate(u8):
            write_png(os.path.join(small, f"{i:06d}.png"), f)
            write_png(os.path.join(big, f"{i:06d}.png"), _resize(f, SERVE_BIG[1], SERVE_BIG[0]))
        write_ms = (time.perf_counter() - t0) * 1e3 / (2 * SERVE_FRAMES)
        weights_npz = export_npz(weights, os.path.join(tmp, "weights.npz"))

        # the host layers, a frame at a time
        files = sorted(os.listdir(small))
        t0 = time.perf_counter()
        decoded = [read_png(os.path.join(small, f)) for f in files]
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(files)
        check(all(np.array_equal(a, b) for a, b in zip(decoded, u8)), "PNG frames round trip")
        adam7 = os.path.join(tmp, "adam7.png")
        with open(adam7, "wb") as f:
            f.write(adam7_png(u8[0]))
        check(np.array_equal(read_png(adam7), decoded[0]),
              "an Adam7-interlaced frame reads as the non-interlaced one")
        t0 = time.perf_counter()
        decoded_big = [read_png(os.path.join(big, f)) for f in sorted(os.listdir(big))]
        decode_big_ms = (time.perf_counter() - t0) * 1e3 / SERVE_FRAMES
        t0 = time.perf_counter()
        resized = [_resize(f, w, h) for f in decoded_big]
        resize_ms = (time.perf_counter() - t0) * 1e3 / SERVE_FRAMES
        t0 = time.perf_counter()
        packed = [rgb_to_i420_cv2(f) for f in decoded]
        i420_ms = (time.perf_counter() - t0) * 1e3 / SERVE_FRAMES
        check(resized[0].shape == (h, w, 3) and packed[0].shape == (h * 3 // 2, w), "host layers' shapes")
        read_fps = 1e3 / decode_ms
        log(f"serving host layers (host clock, a frame): PNG decode {decode_ms:.2f} ms at {h}x{w} "
            f"({read_fps:.1f} frames/s), {decode_big_ms:.2f} ms at {SERVE_BIG[0]}x{SERVE_BIG[1]}; "
            f"area resize {SERVE_BIG[0]}x{SERVE_BIG[1]} -> {h}x{w} {resize_ms:.2f} ms; I420 packing "
            f"{i420_ms:.2f} ms; PNG encode {write_ms:.2f} ms; the {SERVE_FRAMES}-frame render "
            f"{render_s:.1f} s")
        check(read_fps >= SERVE_MIN_READ_FPS,
              f"reading {h}x{w} PNG frames at {read_fps:.1f} frames/s, under {SERVE_MIN_READ_FPS}")

        # infer, its layers timed: bit for bit the runner's depth over the same frames
        out, infer_times = os.path.join(tmp, "infer"), Counter()
        make_runner = _timed(pipelines.make_runner, infer_times, "runner")

        def timed_runner(*args, **kwargs):
            runner = make_runner(*args, **kwargs)
            runner.infer_depth = _timed(runner.infer_depth, infer_times, "forward")
            return runner

        with mock.patch.object(pipelines, "open_source", lambda *a, **k: _TimedSource(
                FrameDirSource(*a[:3], pixel_format=k.get("pixel_format", "float")), infer_times)), \
                mock.patch.object(pipelines, "make_runner", timed_runner), \
                mock.patch.object(pipelines, "colormap_depth", _timed(
                    pipelines.colormap_depth, infer_times, "colormap")), \
                mock.patch.object(pipelines, "write_png", _timed(
                    pipelines.write_png, infer_times, "png")):
            t0 = time.perf_counter()
            check(cli.main(["infer", small, "--weights", weights_npz, "--out", out] + dev) == 0,
                  "cli infer")
            infer_s = time.perf_counter() - t0
        depths = np.load(os.path.join(out, "depths.npy"))
        check(depths.shape == (SERVE_FRAMES, h, w) and np.isfinite(depths).all()
              and (depths > 0).all(), f"infer depths.npy {depths.shape} finite and positive")
        runner = InferenceRunner(cfg, load_npz(weights_npz, cfg.model), device=device)
        want = np.stack([runner.infer_depth(f[None])[0][0] for f in FrameDirSource(small, w, h)])
        check(np.array_equal(depths, want), "infer depths equal InferenceRunner.infer_depth bit for bit")
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        check(len(pngs) == SERVE_FRAMES and all(
            read_png(os.path.join(out, f)).shape == (h, w, 3) for f in pngs), "infer PNGs decode")
        del runner

        # vo on the 432×540 dir, its layers timed; recon on the 256×320 dir; viz
        vo_dir, times = os.path.join(tmp, "vo"), Counter()
        patches = [mock.patch.object(pipelines, "open_source", lambda *a, **k: _TimedSource(
            FrameDirSource(a[0], *a[1:3], pixel_format=k.get("pixel_format", "float")), times))]
        patches += [mock.patch.object(pipelines, name, _timed(getattr(pipelines, name), times, key))
                    for name, key in (("make_runner", "runner"), ("run_vo", "run_vo"),
                                      ("stitch_pointclouds", "stitch"), ("save_ply", "ply"),
                                      ("viz_recon", "figures"), ("viz_trajectory", "figures"))]
        clouds = []
        real_save = pipelines.save_ply
        patches.append(mock.patch.object(pipelines, "save_ply", _timed(
            lambda cloud, path: (clouds.append(cloud), real_save(cloud, path)), times, "ply")))
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            check(cli.main(["vo", big, "--weights", weights_npz, "--out", vo_dir] + dev) == 0, "cli vo")
        vo_s = time.perf_counter() - t0
        poses = np.load(os.path.join(vo_dir, "trajectory.npy"))
        rot = poses[:, :3, :3]
        check(poses.shape == (SERVE_FRAMES, 4, 4) and np.isfinite(poses).all(), "vo trajectory.npy")
        check(np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max() <= 1e-9,
              "vo rotations orthonormal")
        back = load_ply(os.path.join(vo_dir, "reconstruction.ply"))
        check(len(back) == len(clouds[0]) > 0
              and np.abs(back.points - clouds[0].points).max() <= 1e-6
              and np.abs(back.colors - clouds[0].colors).max() <= 1 / 255 + 1e-6,
              "vo PLY round trip (6 decimals, uint8 colours)")
        check(_png_shape(os.path.join(vo_dir, "reconstruction.png")) == (780, 1040, 3)
              and _png_shape(os.path.join(vo_dir, "trajectory.png")) == (780, 910, 3),
              "vo figures decode")
        os.remove(os.path.join(vo_dir, "trajectory.png"))
        check(cli.main(["viz", vo_dir] + dev) == 0
              and _png_shape(os.path.join(vo_dir, "trajectory.png")) == (780, 910, 3), "cli viz")
        rec_dir = os.path.join(tmp, "recon")
        check(cli.main(["recon", small, "--weights", weights_npz, "--out", rec_dir] + dev) == 0
              and np.load(os.path.join(rec_dir, "trajectory.npy")).shape == (SERVE_FRAMES, 4, 4)
              and len(load_ply(os.path.join(rec_dir, "reconstruction.ply"))) > 0, "cli recon")
        layers = " ".join(f"{k} {v * 1e3:.1f}" for k, v in times.items())
        infer_layers = " ".join(f"{k} {v * 1e3:.1f}" for k, v in infer_times.items())
        log(f"serving CLI ({smi}; host clock, {SERVE_FRAMES} frames): infer {SERVE_FRAMES / infer_s:.1f} "
            f"frames/s ({infer_s:.2f} s; layers, ms: {infer_layers}); vo {SERVE_FRAMES / vo_s:.1f} frames/s ({vo_s:.2f} s, "
            f"{SERVE_BIG[0]}x{SERVE_BIG[1]} PNG in); vo layers, ms: {layers}; cloud "
            f"{len(clouds[0])} points")

        # eval on a rendered sequence and on a benchmark dir
        ev = os.path.join(tmp, "eval")
        check(cli.main(["eval", "--weights", weights_npz, "--out", ev] + dev) == 0, "cli eval")
        with open(os.path.join(ev, "metrics.json")) as f:
            metrics = json.load(f)
        keys = list(DEPTH_METRIC_NAMES) + list(EVAL_POSE_KEYS) + list(EVAL_POLYP_KEYS)
        check(sorted(metrics) == sorted(keys), f"eval metrics.json keys {sorted(metrics)}")
        check(all(np.isfinite(v) for v in metrics.values()), f"eval metrics finite: {metrics}")
        for fig, shape in (("qualitative_depth.png", (676, 910, 3)),
                           ("trajectory_predictions.png", (780, 910, 3)),
                           ("colon_reconstruction.png", (780, 1040, 3))):
            check(_png_shape(os.path.join(ev, fig)) == shape, f"eval {fig} decodes")
        log("eval (6-step weights: finite, not accurate): " + " ".join(
            f"{k}={v:.5g}" for k, v in metrics.items()))
        bench = os.path.join(tmp, "bench")
        gt = write_benchmark(bench, seq, write_png)
        for name, (g_frames, g_depth, g_poses, scale) in gt.items():
            # 16-bit PNG depth truncates to a multiple of its scale; .npy is exact
            loaded = load_benchmark_sequence(os.path.join(bench, name), w, h)
            err = np.abs(loaded.gt_depths - g_depth).max()
            check(err <= scale, f"{name} GT depth round trip: {err:.3g} (scale {scale:.3g})")
            check(np.abs(loaded.gt_poses - g_poses).max() <= 1e-6, f"{name} GT poses round trip")
            check(loaded.frames.shape == (SERVE_BENCH, h, w, 3)
                  and np.abs(loaded.frames - g_frames).max() <= 0.5 / 255 + 1e-6,
                  f"{name} frames round trip")
        evb = os.path.join(tmp, "eval_bench")
        check(cli.main(["eval", "--data", bench, "--weights", weights_npz, "--out", evb] + dev) == 0,
              "cli eval --data")
        with open(os.path.join(evb, "metrics.json")) as f:
            bm = json.load(f)
        want_keys = {f"{p}/{kind}/{k}" for p in ("seq_a", "seq_b", "mean")
                     for kind, ks in (("depth", DEPTH_METRIC_NAMES), ("pose", EVAL_POSE_KEYS))
                     for k in ks}
        check(set(bm) == want_keys and all(np.isfinite(v) for v in bm.values()),
              f"eval --data keys and values: {sorted(set(bm) ^ want_keys)}")
        log("eval --data (2 x 24 frames): " + " ".join(
            f"{k}={bm[k]:.5g}" for k in ("mean/depth/abs_rel", "mean/pose/ate", "seq_a/pose/ate",
                                         "seq_b/pose/ate")))

        # import-torch, then vo and eval on the norm="none" weights
        fam = os.path.join(tmp, "family")
        os.makedirs(fam)
        for name, sd in family_checkpoint().items():
            torch.save(sd, os.path.join(fam, f"{name}.pth"))
        imported = os.path.join(tmp, "imported.npz")
        check(cli.main(["import-torch", fam, imported] + dev) == 0, "cli import-torch")
        none_args = ["--weights", imported, "--model.norm=none", "--model.dcdp_fusion=false"] + dev
        vo_none = os.path.join(tmp, "vo_none")
        check(cli.main(["vo", small, "--out", vo_none] + none_args) == 0
              and np.isfinite(np.load(os.path.join(vo_none, "trajectory.npy"))).all(),
              "cli vo on imported weights")
        ev_none = os.path.join(tmp, "eval_none")
        check(cli.main(["eval", "--data", bench, "--out", ev_none] + none_args) == 0,
              "cli eval --data on imported weights")
        with open(os.path.join(ev_none, "metrics.json")) as f:
            check(all(np.isfinite(v) for v in json.load(f).values()), "imported eval metrics finite")
        mcfg = ModelConfig(dtype="float32", norm="none", dcdp_fusion=False)
        f32 = ColvoConfig()
        f32.model = mcfg
        sd = load_npz(imported, mcfg)
        pair = seq.frames[:2], seq.frames[1:3]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            outs = [(r.infer_depth(pair[0])[0], r.infer_pose(*pair)) for r in (
                InferenceRunner(f32, sd, device=device), InferenceRunner(f32, sd, device="cpu"))]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        (d_gpu, p_gpu), (d_cpu, p_cpu) = outs
        err_d = np.abs(d_gpu - d_cpu).max() / np.abs(d_cpu).max()
        err_p = np.abs(p_gpu - p_cpu).max() / np.abs(p_cpu).max()
        log(f"norm=none f32 forward, card vs CPU (TF32 off): depth {err_d:.3g}, pose {err_p:.3g} "
            f"of max")
        check(err_d <= TOL_NONE_CPU_REL and err_p <= TOL_NONE_CPU_REL,
              "norm=none forward on the card equals the CPU's")

        counts = launch_counts()
        check(counts == {}, f"the serving CLI launched training kernels: {counts}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        vo_fn = lambda: cli.main(["vo", big, "--weights", weights_npz,  # noqa: E731
                                  "--out", os.path.join(tmp, "vo_profiled")] + dev)
        busy, wall, _ = busy_share(vo_fn)
    if busy:
        log(f"serving CLI busy share over one cli vo ({smi}): device {busy:.2f} ms of {wall:.2f} "
            f"ms ({100 * busy / wall:.1f} %, profiled); peak device memory {peak:.3f} GiB")
    else:
        log(f"serving CLI busy share: the profiler recorded no device time; not measured; peak "
            f"device memory {peak:.3f} GiB")
    log(f"serving CLI phase: {time.time() - t_phase:.1f} s")


GRAIN_STEPS, GRAIN_CKPT = 6, 3  # the grain runs: steps, and the checkpoint run B resumes from
DP_WORLD, DP_STEPS = 2, 2  # gloo ranks sharing the card, and their steps
TOL_DP_LOSS_REL = 1e-5  # step 1's loss terms, two ranks against one process (the CPU test's)
TOL_DP_GRAD = 1e-4  # step 1's pre-clip gradients, of max |g| (the CPU test's)
REFINE_ITERS, REFINE_BATCH = 40, 64  # refine_keyframe_poses' defaults


def refine_launches(calls: int) -> dict:
    """The launches of ``calls`` calls of the refinement's program (a call a
    batch, and its warm-up): each Adam iteration's warp with d/dx, d/dy (S)
    and its ``global+affine`` LCC's windowed step (L), its SSIM+L1 error
    with its backward (E), and the depth warp; then twice the value-only
    warps, L and E's forward for the keep-or-reject residuals; A's step of
    Adam each iteration."""
    return {"S/grad/C3": REFINE_ITERS * calls, "S/grad/C1": REFINE_ITERS * calls,
            "S/value/C3": 2 * calls, "S/value/C1": 2 * calls,
            "L/affine": (REFINE_ITERS + 2) * calls, "E/fwd/C3": (REFINE_ITERS + 2) * calls,
            "E/bwd/C3": REFINE_ITERS * calls, "A/step": REFINE_ITERS * calls}
TOL_REFINE_POSE = 1e-4  # refined poses, kernel S against the plain sampler (the CPU test's)
REFINE_SHORT = 4  # iterations of the refinement held to TOL_REFINE_POSE (the CPU test's)


def grain_phase(device, smi: str, extra_args=()) -> Counter:
    """``cli train --data.loader=grain --train.deterministic=true`` twice in
    fresh processes at full width on the loop phase's synthetic corpus:
    run A ``GRAIN_STEPS`` steps with a checkpoint every ``GRAIN_CKPT``, run
    B resumed from a copy of A's step-``GRAIN_CKPT`` checkpoint to the same
    step. The two last checkpoints (weights, Adam moments, step counts and
    the loader's ``loader.bin``) must be equal bit for bit. Prints each
    run's ms/step (CUDA events). ``extra_args`` may add overrides. Returns
    the runs' launches."""
    import shutil

    t_phase = time.time()
    cfg = ColvoConfig().apply_overrides(list(extra_args))
    cfg.train.deterministic = True
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        timing = []
        for run in ("A", "B"):
            d = os.path.join(tmp, run)
            if run == "B":
                shutil.copytree(os.path.join(tmp, "A", "ckpt", str(GRAIN_CKPT)),
                                os.path.join(d, "ckpt", str(GRAIN_CKPT)))
            t0 = time.time()
            out = run_child([sys.executable, "-c", DET_CHILD, "train", "--max-steps",
                             str(GRAIN_STEPS), "--log-dir", os.path.join(d, "log"),
                             f"--train.ckpt_dir={d}/ckpt", f"--train.ckpt_every_steps={GRAIN_CKPT}",
                             "--data.loader=grain", "--train.deterministic=true", "--device",
                             device.type, *(["--resume"] if run == "B" else []), *extra_args],
                            f"cli train --data.loader=grain run {run}")
            step_ms, got = child_step_ms(out)
            n_steps = GRAIN_STEPS - (GRAIN_CKPT if run == "B" else 0)
            want = step_launches(cfg, n_steps + STEP_WARMUP)
            check(got == want or device.type == "cpu", f"grain run {run} launches {got} == {want}")
            counts.update(got)
            timing.append((run, time.time() - t0, step_ms))
        ckpts = [os.path.join(tmp, run, "ckpt", str(GRAIN_STEPS)) for run in ("A", "B")]
        loader = [open(os.path.join(c, "loader.bin"), "rb").read() for c in ckpts]
        check(loader[0] == loader[1] and json.loads(loader[0])["next_position"]
              == GRAIN_STEPS * cfg.data.batch_size, f"the grain runs' loader states {loader}")
        flat = [flat_checkpoint(os.path.join(c, "state.pt")) for c in ckpts]
        check(same_checkpoint(flat[0], flat[1]),
              f"grain run B (resumed at step {GRAIN_CKPT}) ends on run A's step-{GRAIN_STEPS} "
              "checkpoint bit for bit")
    log(f"grain loader ({smi}): run B resumed from run A's step-{GRAIN_CKPT} checkpoint and its "
        f"step-{GRAIN_STEPS} checkpoint equals A's bit for bit, loader.bin {loader[0].decode()}")
    for run, wall, step_ms in timing:
        log(f"grain run {run} ({smi}): {wall:.1f} s in all; {np.median(step_ms[1:]):.2f} ms/step "
            f"(CUDA events, median of its steps 2..; all {[round(t, 2) for t in step_ms]})")
    log(f"grain phase: {time.time() - t_phase:.1f} s")
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_phase(device, smi: str, batches, first_default: dict, det_ckpt: dict,
             cfg: ColvoConfig = None, extra_args=()) -> Counter:
    """Data parallel over ``torch.distributed``. One NCCL rank of ``cli
    train --train.deterministic=true`` under ``torch.distributed.run`` on
    the deterministic phase's data and seed: its step-``DET_CKPT``
    checkpoint must equal that phase's bit for bit (the gradient
    all-reduce is the identity at one rank). Then ``DP_WORLD`` gloo ranks
    sharing the card (``dp_rank``), each on its rows of the slice phase's
    batches from the slice phase's initial weights: ``DP_STEPS`` steps of
    ``cfg`` (default ``ColvoConfig()``, bf16 convs), the ranks' weights
    bit-equal after every step, each rank's launches those of its steps,
    step 1's loss terms printed against the slice phase's default step 1
    and its pre-clip gradients against one process's on the global batch.
    cuDNN chooses its convolution algorithm by the batch size, so at 6
    rows it rounds otherwise than at 12 (in bf16, and in float32 too),
    and automask's threshold turns that into gradient differences of up
    to a few per cent. So the CPU test's bounds hold the step in float32
    with TF32 and cuDNN off: one more step from the same weights in that
    precision against one process's, loss terms to 1e-5 relative (the
    gauge to 1e-5 of the total) and gradients to 1e-4 of max |g|.
    Prints the ms/step of the ranks sharing the card. ``extra_args`` are
    the NCCL run's overrides. Returns the ranks' launches."""
    t_phase = time.time()
    cfg = cfg or ColvoConfig()
    counts = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "nccl")
        t0 = time.time()
        run_child([sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node=1", "-m", "colvo_torch.cli", *det_cli_args(d, True, device),
                   *extra_args], "torch.distributed.run cli train (one NCCL rank)")
        nccl_s = time.time() - t0
        got = flat_checkpoint(os.path.join(d, "ckpt", str(DET_CKPT), "state.pt"))
        check(same_checkpoint(got, det_ckpt), f"one NCCL rank's step-{DET_CKPT} checkpoint equals "
              "the deterministic phase's bit for bit")
        log(f"one NCCL rank under torch.distributed.run ({smi}): step-{DET_CKPT} checkpoint equal "
            f"to the single process's bit for bit; {nccl_s:.1f} s in all")

        torch.save([{k: v.cpu() for k, v in b.items()} for b in batches[:DP_STEPS]],
                   os.path.join(tmp, "batches.pt"))
        cfg.dump(os.path.join(tmp, "cfg.json"))
        with open(os.path.join(tmp, "device"), "w") as f:
            f.write(device.type)
        port, procs = _free_port(), []
        for rank in range(DP_WORLD):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env.pop("LOCAL_RANK", None)  # both ranks on the one card
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank", tmp], env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        # one process on the global batch, while the ranks run
        _, grads = recorded_step(init_state(cfg, device=device), batches[0], cfg)
        cfg32 = f32(cfg)
        with no_tf32():
            m32, grads32 = recorded_step(init_state(cfg32, device=device), batches[0], cfg32)
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"gloo rank {rank} exited {p.returncode}:\n" + out[-3000:])
        res = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(DP_WORLD)]
        rank_grads = [torch.load(os.path.join(tmp, f"grads{k}.pt")).to(device)
                      for k in ("", "32")]

    def gerr(got, want):
        check(got.shape == want.shape, "the ranks' gradients have the model's size")
        return ((got - want).abs().max() / want.abs().max()).item()

    m1, r1 = res[0]["metrics"][0], res[0]["metrics32"]
    err, err32 = gerr(rank_grads[0], grads), gerr(rank_grads[1], grads32)

    log(f"data parallel, {DP_WORLD} gloo ranks sharing the card ({smi}), bf16 convs: step 1 "
        "against the slice phase's default step 1: " + " ".join(
            f"{k} {m1[k]:.8g}/{v:.8g}" for k, v in first_default.items())
        + f"; pre-clip gradients {err:.3g} of max |g| from one process's on the global batch; "
        f"weights equal across ranks after each step {[r['same_weights'] for r in res]}; "
        f"launches a rank {res[0]['launches']}")
    log(f"data parallel, float32, TF32 and cuDNN off: step 1 against one process: " + " ".join(
        f"{k} {r1[k]:.8g}/{v:.8g}" for k, v in m32.items())
        + f"; pre-clip gradients {err32:.3g} of max |g|")
    want = step_launches(cfg, DP_STEPS + 1)
    for rank, r in enumerate(res):
        check(r["launches"] == want or device.type == "cpu",
              f"gloo rank {rank} launches {r['launches']} == {want}")
        counts.update(r["launches"])
        check(all(r["same_weights"]), f"rank {rank}'s weights equal rank 0's after every step")
        check(r["metrics"][0] == m1 and r["metrics32"] == r1,
              f"rank {rank}'s step-1 metrics are rank 0's")
    for k, v in m32.items():
        # the gauge hinge squares a small difference: held relative to the total
        scale = abs(m32["loss/total"] if k == "loss/gauge" else v)
        check(abs(r1[k] - v) <= TOL_DP_LOSS_REL * max(scale, 1e-6),
              f"float32 step 1 {k}: {DP_WORLD} ranks {r1[k]} vs one process {v}")
    check(err32 <= TOL_DP_GRAD, f"float32 step 1 pre-clip gradients, {DP_WORLD} ranks against "
          f"one process: {err32:.3g} of max |g|")
    log(f"data parallel ms/step of the {DP_WORLD} ranks sharing one card ({smi}; host clock "
        f"around each synchronised train_step, a record with no target): "
        + ", ".join(f"rank {r} {[round(t, 2) for t in x['ms']]}" for r, x in enumerate(res)))
    log(f"data-parallel phase: {time.time() - t_phase:.1f} s")
    return counts


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls without TF32, and convolutions by PyTorch's own
    im2col + GEMM instead of cuDNN (whose algorithm, chosen by the batch
    size, may be Winograd or FFT in float32), restored on exit."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.enabled
    cuda.allow_tf32, cudnn.enabled = False, False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.enabled = saved


def f32(cfg: ColvoConfig) -> ColvoConfig:
    """``cfg`` with float32 convolutions."""
    out = ColvoConfig.from_dict(cfg.to_dict())
    out.model.dtype = "float32"
    return out


def recorded_step(state, batch, cfg: ColvoConfig) -> tuple:
    """One ``train_step``, with the gradients the clip receives (summed
    over the ranks under a mesh) as one flat tensor: (metrics, grads)."""
    import importlib

    ts = importlib.import_module("colvo_torch.runtime.train_step")
    grads, clip = [], ts.clip_by_global_norm

    def recording(gs, max_norm):
        grads.append(torch.cat([g.reshape(-1) for g in gs]).clone())
        return clip(gs, max_norm)

    with mock.patch.object(ts, "clip_by_global_norm", recording):
        metrics = train_step(state, batch, cfg)
    return {k: v.item() for k, v in metrics.items()}, grads[0]


def dp_rank(tmp: str) -> None:
    """One gloo rank of ``dp_phase``, on ``cuda:0`` beside the others (or
    the CPU, as ``tmp/device`` says): the slice phase's initial weights
    (rank 0's, broadcast), its rows of each of ``tmp``'s batches,
    ``DP_STEPS`` train steps of ``tmp/cfg.json``'s configuration, then one
    step from the same initial weights in float32 with TF32 and cuDNN off. Writes
    ``rank<r>.json`` (metrics, ms, launches, weights equal to rank 0's
    after each step) and, on rank 0, the two step 1s' pre-clip gradients."""
    from colvo_torch.runtime import mesh as mesh_mod

    check(mesh_mod.maybe_init_distributed("gloo"), "joined the gloo group")
    cuda = open(os.path.join(tmp, "device")).read() == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = ColvoConfig.load(os.path.join(tmp, "cfg.json"))
    mesh = mesh_mod.make_mesh(cfg.mesh)
    batches = [{k: v.to(device) for k, v in mesh_mod.shard_batch(b, mesh).items()}
               for b in torch.load(os.path.join(tmp, "batches.pt"))]

    def replicated(cfg_):
        state = init_state(cfg_, device=device)
        mesh_mod.replicate_tree(state.model, mesh)
        state.mesh = mesh
        return state

    state = replicated(cfg)
    out = {"metrics": [], "ms": [], "same_weights": []}
    reset_launch_counts()
    for i in range(DP_STEPS):
        sync()
        t0 = time.perf_counter()
        if i == 0:
            metrics, grads = recorded_step(state, batches[i], cfg)
        else:
            metrics = {k: v.item() for k, v in train_step(state, batches[i], cfg).items()}
        sync()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["metrics"].append(metrics)
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        ref = flat.clone()
        torch.distributed.broadcast(ref, src=0)
        out["same_weights"].append(bool(torch.equal(flat, ref)))
    del state
    with no_tf32():
        cfg32 = f32(cfg)
        out["metrics32"], grads32 = recorded_step(replicated(cfg32), batches[0], cfg32)
    out["launches"] = launch_counts()
    if mesh.rank == 0:
        torch.save(grads.cpu(), os.path.join(tmp, "grads.pt"))
        torch.save(grads32.cpu(), os.path.join(tmp, "grads32.pt"))
    with open(os.path.join(tmp, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _rot_err_deg(a, b) -> float:
    r = a[:3, :3].T @ b[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1))))


def refine_phase(device, smi: str, vo_inputs: dict) -> Counter:
    """Keyframe pose refinement on the card. The reference test's contract
    (tests/test_refine.py) at full width: a 1.2° + 2.7 mm error injected at
    keyframe 4 must shrink below 0.5× and 0.7×, keyframe 0 and the
    intra-segment chains stay put; with the plain sampler the same call
    after the CPU test's 4 iterations gives the same poses to its bound
    (after 40 Adam steps, whose first moves are ±lr·sign(g), they drift
    further: a record). Then
    ``refine_keyframe_poses`` on the VO phase's 64-frame result (a
    keyframe a frame, so 63 pairs in one padded batch of 64): its
    ``_segment_loss`` and delta gradient against the plain sampler's at
    the CPU test's bounds and its poses after 4 iterations to 1e-4, its
    launches (2·iters of S with d/dx, d/dy: the frame, C=3, and the depth,
    C=1, an iteration; 4 value-only a batch), a residual that does not
    grow, ms a call; its 40-iteration poses beside the plain sampler's, as
    a record. Returns the launches of the two kernel calls
    checked."""
    from colvo_torch.data.synthetic import default_intrinsics, make_trajectory, render_frame
    from colvo_torch.vo import refine as refine_mod

    t_phase = time.time()
    cfg = ColvoConfig()
    h, w = cfg.data.height, cfg.data.width

    @contextlib.contextmanager
    def plain_sampler():
        # A program replays the kernels it captured: the plain sampler's
        # calls capture programs of their own, dropped after them.
        refine_mod._refine.programs.clear()
        try:
            with mock.patch.object(sampler, "sample", sampler.sample_plain):
                yield
        finally:
            refine_mod._refine.programs.clear()

    k = default_intrinsics(h, w)
    gt = make_trajectory(8, step=0.004, wobble=0.3, seed=31).astype(np.float64)
    frames, depths = zip(*(render_frame(gt[i], k, h, w, radius=0.03) for i in (0, 4)))
    poses = gt.copy()
    bump = np.eye(4)
    th = np.radians(1.2)
    bump[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    bump[:3, 3] = [0.002, -0.001, 0.0015]
    poses[4:] = np.einsum("ij,njk->nik", bump, poses[4:])
    err0 = _rot_err_deg(poses[4], gt[4])
    t_err0 = float(np.linalg.norm(poses[4][:3, 3] - gt[4][:3, 3]))
    contract = dict(keyframe_ids=[0, 4], depths=[d.astype(np.float32) for d in depths],
                    frames_kf=np.stack(frames).astype(np.float32), k=k, iters=REFINE_ITERS,
                    lr=2e-3, batch=1, device=device)
    reset_launch_counts()
    refined, stats = refine_mod.refine_keyframe_poses(poses, **contract)
    counts = Counter(launch_counts())
    with plain_sampler():
        refined_plain, _ = refine_mod.refine_keyframe_poses(poses, **contract)
    perr = float(np.abs(refined - refined_plain).max())
    short = {**contract, "iters": REFINE_SHORT}
    with plain_sampler():
        short_plain, _ = refine_mod.refine_keyframe_poses(poses, **short)
    perr_short = float(np.abs(refine_mod.refine_keyframe_poses(poses, **short)[0]
                              - short_plain).max())
    err1 = _rot_err_deg(refined[4], gt[4])
    t_err1 = float(np.linalg.norm(refined[4][:3, 3] - gt[4][:3, 3]))
    log(f"refine contract at {h}x{w} ({smi}): {err0:.4f}° -> {err1:.4f}° ({err1 / err0:.3f}×, "
        f"under 0.5), {1e3 * t_err0:.4f} mm -> {1e3 * t_err1:.4f} mm ({t_err1 / t_err0:.3f}×, "
        f"under 0.7); residual {stats['residual_before']:.6g} -> {stats['residual_after']:.6g}; "
        f"poses within {perr:.3g} of the plain sampler's ({perr_short:.3g} after "
        f"{REFINE_SHORT} iterations)")
    check(stats["residual_after"] <= stats["residual_before"] + 1e-9, f"refine residual {stats}")
    check(err1 < 0.5 * err0 and t_err1 < 0.7 * t_err0, "refine recovers the injected error")
    check(np.allclose(refined[0], poses[0], atol=1e-12) and all(
        np.allclose(np.linalg.inv(refined[a]) @ refined[b], np.linalg.inv(poses[a]) @ poses[b],
                    atol=1e-9) for a, b in ((0, 2), (4, 6))), "refine keeps keyframe 0 and "
          "the intra-segment chains")
    check(perr_short <= TOL_REFINE_POSE, f"refine contract, {REFINE_SHORT} iterations, kernel S "
          f"against the plain sampler: {perr_short:.3g}")

    m = len(vo_inputs["keyframe_ids"]) - 1
    n_batches = -(-m // REFINE_BATCH)
    seen = []
    real_refine = refine_mod._refine

    def keep_args(*args, **kwargs):
        seen.append(args)
        return real_refine(*args, **kwargs)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(refine_mod, "_refine", keep_args):
        got, stats = refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
    first_ms = 1e3 * (time.perf_counter() - t0)
    vo_counts = launch_counts()
    # a program's first call warms up once, then every batch is a replay
    calls = STEP_WARMUP + n_batches
    want = refine_launches(calls)
    check(vo_counts == want or device.type == "cpu", f"refine launches {vo_counts} == {want}")
    counts.update(vo_counts)
    check(np.isfinite(got).all() and stats["residual_after"] <= stats["residual_before"],
          f"refine on the VO result: finite poses, a residual that does not grow {stats}")
    # the loss and its delta gradient on the call's own batch, at 0 and a small delta
    rel, fi, fj, di, dj, kk = seen[0]
    args = (rel, fi, fj, di, dj, kk, torch.linalg.inv(kk), 0.5)
    gen = torch.Generator().manual_seed(3)
    lerr, gerr = 0.0, 0.0
    for scale in (0.0, 2e-3):
        delta = (scale * torch.randn((rel.shape[0], 6), generator=gen)).to(device)
        outs = []
        for ctx in (contextlib.nullcontext(), plain_sampler()):
            d = delta.clone().requires_grad_(True)
            with ctx:
                loss, _ = refine_mod._segment_loss(d, *args)
                loss.backward()
            outs.append((loss.item(), d.grad))
        (lk, gk), (lp, gp) = outs
        lerr = max(lerr, abs(lk - lp) / abs(lp))
        gerr = max(gerr, ((gk - gp).abs().max() / gp.abs().max()).item())
    with plain_sampler():
        t0 = time.perf_counter()
        got_plain, plain_stats = refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        short_plain, _ = refine_mod.refine_keyframe_poses(**vo_inputs, device=device,
                                                          iters=REFINE_SHORT)
    vo_short = float(np.abs(refine_mod.refine_keyframe_poses(
        **vo_inputs, device=device, iters=REFINE_SHORT)[0] - short_plain).max())
    refine_mod.refine_keyframe_poses(**vo_inputs, device=device)  # captures the program
    t0 = time.perf_counter()
    refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
    ms = 1e3 * (time.perf_counter() - t0)
    seg = lambda p: np.stack([np.linalg.inv(a) @ b for a, b in zip(p[:-1], p[1:])])  # noqa: E731
    log(f"refine_keyframe_poses on the VO phase's {m + 1} keyframes ({m} pairs, {n_batches} "
        f"padded batch of {REFINE_BATCH}, {REFINE_ITERS} iterations; {smi}): _segment_loss "
        f"{lerr:.3g} relative and its delta gradient {gerr:.3g} of max from the plain sampler's, "
        f"the poses after {REFINE_SHORT} iterations {vo_short:.3g}; "
        f"residual {stats['residual_before']:.6g} -> {stats['residual_after']:.6g} (plain "
        f"{plain_stats['residual_after']:.6g}); poses {np.abs(got - got_plain).max():.3g} and "
        f"frame-to-frame steps {np.abs(seg(got) - seg(got_plain)).max():.3g} from the plain "
        f"sampler's (a record: 40 Adam steps on a flat residual); launches {vo_counts}; "
        f"{ms:.1f} ms a call (host clock, a replay and the call's own sync; the first, with its "
        f"warm-up and capture, {first_ms:.1f} ms; the plain sampler's first {plain_ms:.1f} ms)")
    check(lerr <= 1e-5 and gerr <= 1e-4 and vo_short <= TOL_REFINE_POSE,
          f"refine on the VO result against the plain sampler: _segment_loss {lerr:.3g} "
          f"relative, its gradient {gerr:.3g} of max, poses after {REFINE_SHORT} iterations "
          f"{vo_short:.3g}")
    log(f"refine phase: {time.time() - t_phase:.1f} s")
    return counts


GRAPH_STEPS = 3  # steps of the graphs phase's eager and captured runs, from one init
GRAPH_TIMED = 5  # more replays of the captured step, timed
GRAPH_LOOP_STEPS, GRAPH_LOOP_PROFILE = 9, (1, 9)  # each loader's loop: 8 profiled replays
GRAPH_LOADERS = ("numpy", "grain", "device")
# Captured against eager default steps from the same weights and batches,
# as the card test of the chunk holds them (a second eager run beside them
# shows the floor): T adds with float atomics, in another order each run,
# so step 1's gradients differ in their last bits (grad_norm to 1e-4
# relative), and later steps start from weights that do: their loss terms
# are held at the widening tolerances of equivalent programs run apart,
# 1e-3 and 1e-2 relative (tests/test_device_store.py:149-152), their
# grad_norm is a record (a near-tie automask decision moves it by ~2e-3).
# Adam moves a weight by at most ~lr a step (|m̂|/√v̂ ≤ 1.004 over 3 steps)
# whatever its gradient's size, so the weights after GRAPH_STEPS steps are
# held within 2·GRAPH_STEPS·lr·1.004 of the eager run's.
TOL_GRAPH_STEPS = (1e-4, 1e-3, 1e-2)
# A fresh process (cuBLAS reads CUBLAS_WORKSPACE_CONFIG when its handle is
# made): GRAPH_STEPS eager and captured deterministic steps from one init,
# each timed by CUDA events; prints whether metrics, weights and Adam
# moments are equal bit for bit, the ms and the kernel launches.
GRAPH_DET_CHILD = """
import json, sys
import torch
from colvo_torch.config import ColvoConfig
from colvo_torch.data import batch_iterator, synthetic_dataset
from colvo_torch.kernels import launch_counts
from colvo_torch.runtime import init_state, make_train_step, to_device, train_step
from colvo_torch.runtime.loop import deterministic_mode

dev = torch.device(sys.argv[1])
n_steps = int(sys.argv[2])
cfg = ColvoConfig().apply_overrides(sys.argv[3:])
cfg.train.deterministic = True
it = batch_iterator(synthetic_dataset(cfg.data, n_sequences=2, n_frames=8), cfg.data, seed=0)
batches = [to_device(next(it), dev) for _ in range(n_steps)]


def timed(fn):
    if dev.type != "cuda":
        return fn(), float("nan")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


with deterministic_mode(True):
    eager = init_state(cfg, device=dev)
    graphed = init_state(cfg, device=dev)
    step_fn = make_train_step(graphed, cfg)
    same, ms = True, {"eager": [], "captured": []}
    for batch in batches:
        want, t_eager = timed(lambda: train_step(eager, batch, cfg))
        got, t_graph = timed(lambda: step_fn(graphed, batch))
        ms["eager"].append(t_eager)
        ms["captured"].append(t_graph)
        same = same and all(torch.equal(got[k], v) for k, v in want.items())
    for p, q in zip(eager.model.parameters(), graphed.model.parameters()):
        a, b = eager.optimizer.state[p], graphed.optimizer.state[q]
        same = same and torch.equal(p, q) and all(torch.equal(a[k], b[k]) for k in a)
print("graph det " + json.dumps({"same": bool(same), "ms": ms, "launches": launch_counts()}),
      flush=True)
"""


def graphs_phase(device, smi: str, weights: dict, batches, dataset, vo_inputs: dict,
                 extra_args=()) -> Counter:
    """Each captured program held against its eager body, from the same
    inputs and state, with both times (the body by CUDA events around
    eager calls, the program around its replays) and peak memory.
    Serving: ``infer_coupled`` and ``run_vo`` in every input format and
    wire (and symmetric pose), bit for bit (the decoded wires: depths and
    poses); the card's busy share over one ``run_vo``. Training:
    ``GRAPH_STEPS`` default steps, step 1's loss terms bit for bit,
    grad_norm and the weights after them to ``TOL_GRAPH_REL``; the
    captured step's peak memory at most 2× the eager step's; under
    ``train.deterministic``, in a fresh process, the metrics, weights and
    Adam moments bit for bit. The loop on each of ``GRAPH_LOADERS`` for
    ``GRAPH_LOOP_STEPS`` steps with the profiler over 8 replays: the
    steps are one ``TrainStep``'s replays, its launches the warm-up's plus
    the captured ones × the replays, the card's busy share and ms/step.
    Refine: ``refine_keyframe_poses`` on the VO result, bit for bit or
    within 1e-6. Returns the launches of the phase's programs."""
    from colvo_torch.runtime import loop as loop_mod
    from colvo_torch.runtime import make_train_step
    from colvo_torch.runtime.infer import _coupled_body
    from colvo_torch.vo import StreamingVO, run_vo
    from colvo_torch.vo import refine as refine_mod
    from colvo_torch.vo.stream import _init_body, rgb_to_i420

    t_phase = time.time()
    on_card = device.type == "cuda"
    timer = eager_ms if on_card else (lambda fn: (fn(), float("nan"))[1])
    cfg = ColvoConfig().apply_overrides(list(extra_args))
    counts, table = Counter(), []
    gib = lambda b: b / 2**30  # noqa: E731

    # --- serving
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    runner = InferenceRunner(cfg, weights, device=device)
    u8 = np.asarray(vo_inputs["frames_kf"])
    f32 = u8.astype(np.float32) / 255.0
    got = runner.infer_coupled(f32[:4], f32[1:5])
    with torch.inference_mode():
        a, b = (torch.from_numpy(x).to(device) for x in (f32[:4], f32[1:5]))
        want = [t.cpu().numpy() for t in _coupled_body(runner, a, b)]
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              "infer_coupled: the program's outputs equal its eager body's bit for bit")
        prog = runner.program(_coupled_body)
        table.append(("infer_coupled (4 pairs)", timer(lambda: _coupled_body(runner, a, b)),
                      timer(lambda: prog(a, b))))
    inputs = {"rgb": list(u8), "i420": list(rgb_to_i420(u8)),
              "i420full": list(rgb_to_i420(u8, video_range=False))}

    def eager_init(vo, frame):
        return _init_body(vo.runner, frame, input_format=vo.input_format)

    modes = [(fmt, wire, False) for fmt in inputs for wire in ("float32", "float16", "uint8")]
    for fmt, wire, sym in modes + [("rgb", "float16", True)]:
        kw = dict(chunk_size=VO_CHUNK, depth_dtype=wire, input_format=fmt, symmetric_pose=sym)
        d_g, p_g = StreamingVO(runner, **kw).run(inputs[fmt])
        with mock.patch.object(StreamingVO, "chunk_step", StreamingVO.chunk_body), \
                mock.patch.object(StreamingVO, "init_step", eager_init):
            d_e, p_e = StreamingVO(runner, **kw).run(inputs[fmt])
        check(np.array_equal(p_g, p_e) and len(d_g) == len(d_e)
              and all(np.array_equal(x, y) for x, y in zip(d_g, d_e)),
              f"run_vo {fmt}/{wire}{' symmetric' if sym else ''}: the programs' wires equal "
              "the eager bodies' bit for bit")
    with torch.inference_mode():
        sv = StreamingVO(runner, chunk_size=VO_CHUNK)
        f0 = torch.from_numpy(u8[:1]).to(device)
        chunk = torch.from_numpy(np.stack(u8[1:1 + VO_CHUNK])).to(device)
        table.append(("init_step (1 frame)", timer(lambda: _init_body(runner, f0, "rgb")),
                      timer(lambda: sv.init_step(f0))))
        _, ci, cb = (x.clone() for x in sv.init_step(f0))
        table.append((f"chunk_step ({VO_CHUNK} frames)", timer(lambda: sv.chunk_body(ci, cb, chunk)),
                      timer(lambda: sv.chunk_step(ci, cb, chunk))))
    vo_fn = lambda: run_vo(runner, inputs["rgb"], keyframe_every=1, chunk_size=VO_CHUNK)  # noqa
    busy, wall, _ = busy_share(vo_fn) if on_card else (float("nan"), float("nan"), {})
    serve_peak = gib(torch.cuda.max_memory_allocated() - held)
    log(f"graphs, serving ({smi}): infer_coupled and run_vo in {len(modes) + 1} modes (rgb, "
        f"i420, i420full × float32, float16, uint8; rgb/float16 symmetric) equal their eager "
        f"bodies bit for bit; one run_vo of {len(u8)} frames: the card busy {busy:.2f} ms of "
        f"{wall:.2f} ms ({100 * busy / wall:.1f} %, profiled); the runner's programs and runs "
        f"peaked {serve_peak:.3f} GiB above the {gib(held):.3f} GiB held before them")
    del runner, prog, sv, ci, cb

    # --- training, the default path: eager steps, then captured ones, from one init
    def cloned(m):
        return {k: v.clone() for k, v in m.items()}

    def step_events(fn):
        if not on_card:
            return fn(), float("nan")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        return out, (e0, e1)

    peaks, runs, replay_ms = {}, {}, float("nan")
    for kind in ("eager", "eager again", "captured"):
        state = init_state(cfg, device=device)
        step = make_train_step(state, cfg) if kind == "captured" else (
            lambda state_, batch: train_step(state_, batch, cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = []
        for i in range(GRAPH_STEPS):
            m, ev = step_events(lambda: cloned(step(state, batches[i])))
            out.append((m, ev))
            if i == 0:
                torch.cuda.synchronize()
                peaks[kind] = gib(torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for _, (a, b) in out] if on_card else [float("nan")]
        runs[kind] = ([m for m, _ in out], [p.detach().clone() for p in state.model.parameters()],
                      ms)
        if kind == "captured" and on_card:  # after the weights are taken
            replay_ms = _events_ms(lambda: step(state, batches[GRAPH_STEPS]), GRAPH_TIMED)
        del state, step, out
    m_e, w_e, ms_e = runs["eager"]
    w0 = [p.detach() for p in init_state(cfg, device=device).model.parameters()]

    def apart(kind):
        """Per step, each metric's relative difference from the eager run's;
        the largest |Δw| after the steps and ‖Δw‖ over the eager update's
        norm ‖w − w0‖."""
        m, w = runs[kind][:2]
        rel = [{k: abs(a[k].item() - b[k].item()) / max(abs(b[k].item()), 1e-12) for k in b}
               for a, b in zip(m, m_e)]
        diff = torch.stack([torch.linalg.vector_norm(p - q) for p, q in zip(w, w_e)])
        upd = torch.stack([torch.linalg.vector_norm(q - r) for q, r in zip(w_e, w0)])
        return (rel, max((p - q).abs().max().item() for p, q in zip(w, w_e)),
                (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(upd)).item())

    (rel_g, dw_g, nw_g), (rel_e, dw_e, nw_e) = apart("captured"), apart("eager again")
    m_g, _, ms_g = runs["captured"]
    w_tol = 2 * GRAPH_STEPS * cfg.train.lr * 1.004

    def worst(rel, i, grad_norm):
        return max(v for k, v in rel[i].items() if (k == "grad_norm") == grad_norm)

    log(f"graphs, the default step ({smi}), captured against eager by step (a second eager "
        f"run in brackets): loss terms {[f'{worst(rel_g, i, False):.3g} [{worst(rel_e, i, False):.3g}]' for i in range(GRAPH_STEPS)]}, "
        f"grad_norm {[f'{worst(rel_g, i, True):.3g} [{worst(rel_e, i, True):.3g}]' for i in range(GRAPH_STEPS)]} "
        f"relative; the weights after {GRAPH_STEPS} steps max |Δw| {dw_g:.3g} [{dw_e:.3g}] "
        f"(lr {cfg.train.lr:g}), ‖Δw‖ {nw_g:.3g} [{nw_e:.3g}] of the update's norm; peak memory "
        f"{peaks['eager']:.2f} GiB eager, {peaks['captured']:.2f} GiB over the first captured "
        f"call (warm-up, capture, replay); ms a step by CUDA events: eager "
        f"{[round(t, 2) for t in ms_e]}, captured {[round(t, 2) for t in ms_g]} (the first with "
        f"its warm-up and capture), {replay_ms:.2f} a replay over {GRAPH_TIMED}")
    check(all(torch.equal(m_g[0][k], v) for k, v in m_e[0].items() if k != "grad_norm"),
          "captured step 1's loss terms equal the eager step's bit for bit")
    check(worst(rel_g, 0, True) <= TOL_GRAPH_STEPS[0]
          and all(worst(rel_g, i, False) <= TOL_GRAPH_STEPS[i] for i in range(GRAPH_STEPS))
          and dw_g <= w_tol,
          f"captured against eager: step 1's grad_norm, the later steps' loss terms within "
          f"{TOL_GRAPH_STEPS}; the weights within {w_tol:.3g}")
    check(peaks["captured"] <= 2 * peaks["eager"],
          f"the captured step's peak {peaks['captured']:.2f} GiB within 2× the eager step's "
          f"{peaks['eager']:.2f} GiB")
    table.append(("train step (default)", float(np.median(ms_e[1:])), replay_ms))
    del runs, m_e, m_g, w_e, w0

    # --- training, deterministic, in a fresh process
    out = run_child([sys.executable, "-c", GRAPH_DET_CHILD, device.type, str(GRAPH_STEPS),
                     *extra_args], "graphs phase: deterministic eager and captured steps")
    det = json.loads(out.rsplit("graph det ", 1)[1].splitlines()[0])
    check(det["same"], f"{GRAPH_STEPS} deterministic captured steps equal {GRAPH_STEPS} eager "
          "ones bit for bit (metrics, weights, Adam moments)")
    counts.update(det["launches"])
    table.append(("train step (deterministic)", float(np.median(det["ms"]["eager"][1:])),
                  float(np.median(det["ms"]["captured"][1:]))))
    log(f"graphs, deterministic ({smi}): {GRAPH_STEPS} captured steps equal {GRAPH_STEPS} eager "
        f"ones bit for bit in a fresh process; ms by CUDA events: eager {det['ms']['eager']}, "
        f"captured {det['ms']['captured']}; launches {det['launches']}")

    # --- the loop on each loader, 8 replays under the profiler
    for loader in GRAPH_LOADERS:
        lcfg = ColvoConfig().apply_overrides(list(extra_args))
        lcfg.data.loader = loader
        lcfg.train.eval_every_epochs = 0
        lcfg.train.log_every = 1
        lcfg.train.profile_steps = "{}:{}".format(*GRAPH_LOOP_PROFILE)
        kinds, starts = [], []

        def timed(step_fn):
            kinds.append(type(step_fn).__name__)

            def step(*args):
                starts.append(time.perf_counter())
                return step_fn(*args)
            return step

        with tempfile.TemporaryDirectory() as tmp, wrap_step_fns(timed):
            lcfg.train.ckpt_dir = os.path.join(tmp, "ckpt")
            reset_launch_counts()
            loop_mod.train(lcfg, dataset, log_dir=tmp, max_steps=GRAPH_LOOP_STEPS, device=device)
            got = launch_counts()
            trace = os.path.join(tmp, "trace_steps_{}_{}.json".format(*GRAPH_LOOP_PROFILE))
            busy, window = trace_busy(trace) if on_card else (float("nan"), float("nan"))
        check(kinds == ["TrainStep"], f"the {loader} loader's steps are one program's: {kinds}")
        want = step_launches(lcfg, GRAPH_LOOP_STEPS + STEP_WARMUP)
        check(got == want or not on_card, f"{loader} loop launches {got} == {want}")
        counts.update(got)
        gaps = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
        log(f"graphs, the loop on the {loader} loader ({smi}): {GRAPH_LOOP_STEPS} steps, one "
            f"captured step's replays; the card busy {busy:.2f} ms of the {window:.2f} ms "
            "window of steps {}-{} ({:.1f} %, profiled); a step started every {:.2f} ms "
            "(median of steps 3-{}; all {})".format(
                *GRAPH_LOOP_PROFILE, 100 * busy / window, float(np.median(gaps[1:])),
                GRAPH_LOOP_STEPS, [round(g, 1) for g in gaps]))

    # --- refine on the VO result: the program against its body
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _ = refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
    first_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got, _ = refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
    graph_ms = 1e3 * (time.perf_counter() - t0)
    counts.update(launch_counts())
    with mock.patch.object(refine_mod, "_refine", refine_mod._refine_body):
        refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
        t0 = time.perf_counter()
        want, _ = refine_mod.refine_keyframe_poses(**vo_inputs, device=device)
        eager_call_ms = 1e3 * (time.perf_counter() - t0)
    err = float(np.abs(got - want).max())
    check(err <= 1e-6, f"refine_keyframe_poses: the program's poses within 1e-6 of the eager "
          f"body's ({err:.3g})")
    pairs = len(vo_inputs["keyframe_ids"]) - 1
    table.append((f"refine_keyframe_poses ({pairs} pairs; host clock)", eager_call_ms, graph_ms))
    log(f"graphs, refine ({smi}): the program's poses {err:.3g} from the eager body's (max "
        f"abs); a call {graph_ms:.1f} ms (host clock, synchronised), eager {eager_call_ms:.1f} "
        f"ms; the first call in this phase {first_ms:.1f} ms")

    # --- the device loader's batch and the eval hook's forward
    table += batch_program_rows(device, smi, cfg, dataset, timer)
    table += eval_program_rows(device, smi, cfg, weights, timer)

    log(f"graphs ({smi}): program, eager body ms, program ms (CUDA events unless said)")
    for name, eager, graphed in table:
        log(f"  {name:58s} {eager:9.3f} {graphed:9.3f}")
    log(f"graphs phase: {time.time() - t_phase:.1f} s")
    return counts


GRAPH_BATCHES, GRAPH_BATCH_SEED = 3, 5  # batches of the store's program held to eager ones
GRAPH_BATCH_TIMED = 4  # more batches, timed, in the same epoch
GRAPH_HOOK_CALLS = 3  # eval hook calls: the first captures, the others replay


def batch_program_rows(device, smi: str, cfg: ColvoConfig, dataset, timer) -> list:
    """The device store's batch program (``data/device_store.py``) against
    eager ``gather`` + ``device_augment`` from the same seed's permutation
    and generator: ``GRAPH_BATCHES`` batches bit for bit, no kernel of ours
    launched; replay ms against eager ms (CUDA events). Returns its row of
    the phase's table."""
    from colvo_torch.data import DeviceSnippetStore, device_augment
    from colvo_torch.data.device_store import gather

    store = DeviceSnippetStore(dataset.sequences, dataset.intrinsics, cfg.data.frame_offsets,
                               device=device)
    b = cfg.data.batch_size
    check(store.n_snippets >= (GRAPH_BATCHES + GRAPH_BATCH_TIMED) * b,
          f"{store.n_snippets} snippets hold the checked and timed batches in one epoch")
    reset_launch_counts()
    it = store.batches(cfg.data, seed=GRAPH_BATCH_SEED)
    got = [{k: v.clone() for k, v in next(it).items()} for _ in range(GRAPH_BATCHES)]
    launches = launch_counts()
    rng = np.random.default_rng(GRAPH_BATCH_SEED)
    gen = torch.Generator(device=device).manual_seed(GRAPH_BATCH_SEED)
    order = torch.from_numpy(rng.permutation(store.n_snippets)).to(device)
    same = []
    for i, batch in enumerate(got):
        aug, clean = device_augment(gather(store.frames, store.table, order[i * b:(i + 1) * b]),
                                    gen, cfg.data)
        same.append(torch.equal(batch["frames"], aug) and torch.equal(batch["frames_clean"], clean)
                    and torch.equal(batch["k"], store.k))
    progs = list(store.program.programs.values())
    check(all(same) and launches == {} and len(progs) == 1
          and (progs[0].graph is not None or device.type != "cuda"),
          f"the batch program: {GRAPH_BATCHES} batches equal the eager gather + augment bit for "
          f"bit {same}, one program {len(progs)}, no kernel launched {launches}")
    replay = (_events_ms(lambda: next(it), GRAPH_BATCH_TIMED) if device.type == "cuda"
              else float("nan"))
    idx = order[:b]
    eager = timer(lambda: device_augment(gather(store.frames, store.table, idx), gen, cfg.data))
    log(f"graphs, the device loader's batch ({smi}): {GRAPH_BATCHES} batches of the program "
        f"(B={b}, augmentation on) equal the eager gather + device_augment from seed "
        f"{GRAPH_BATCH_SEED} bit for bit; launches {launches}; {replay:.4f} ms a batch replayed "
        f"(CUDA events over {GRAPH_BATCH_TIMED} batches, the host's slice included), {eager:.4f} ms "
        f"eager")
    return [(f"device-loader batch (B={b})", eager, replay)]


def eval_program_rows(device, smi: str, cfg: ColvoConfig, weights: dict, timer) -> list:
    """The eval hook's captured forward (``pipelines.TrainingEvalHook``) on
    ``weights``: ``GRAPH_HOOK_CALLS`` calls of the hook writing its panels
    (the first captures, the others replay one program), each call's split
    into the wait for queued work, forward, host metrics and panel writes;
    the program's outputs
    against its eager body on the same weights, bit for bit (or within 1e-6
    of each output's max, the reason logged); of our kernels only L
    launched (``eval_hook_launches``); replay ms against eager ms (CUDA
    events). Returns its row."""
    import types

    from colvo_torch.models import ColVOModel
    from colvo_torch.pipelines import make_training_eval_hook
    from colvo_torch.runtime import MetricsWriter

    model = ColVOModel(cfg.model)
    model.load_state_dict(weights)
    model.to(device).train()
    hook = make_training_eval_hook(cfg, model)
    state = types.SimpleNamespace(model=model)
    reset_launch_counts()
    splits, programs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        writer = MetricsWriter(tmp, also_stdout=False)
        for step in range(GRAPH_HOOK_CALLS):
            t_ns = time.perf_counter_ns()
            scalars = hook(step, state, writer)
            splits.append(eval_calls(t_ns)[0])
            programs.append(hook.program)
            check(all(np.isfinite(v) for v in scalars.values()), f"eval scalars {scalars}")
        writer.close()
        panels = sorted(f for f in os.listdir(tmp) if f.startswith("panels_"))
    launches = launch_counts()
    got = [t.clone() for t in hook.program()]
    model.eval()
    want = hook.forward(model)
    rel = [((a.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)).item()
           for a, w in zip(got, want)]
    same = all(torch.equal(a, w) for a, w in zip(got, want))
    want_launches = eval_hook_launches(cfg, GRAPH_HOOK_CALLS)
    check((same or max(rel) <= 1e-6) and launches == want_launches
          and all(p is programs[0] for p in programs) and len(programs[0].programs) == 1
          and len(panels) == 3 * GRAPH_HOOK_CALLS,
          f"the eval hook's program against its eager body: bit for bit {same}, of max {rel}; "
          f"one program over {GRAPH_HOOK_CALLS} calls; launches {launches}; panels {panels}")
    if not same:
        log("graphs, the eval hook: the program differs from its eager body in the last bits "
            f"(of each output's max {rel}): cuDNN may choose another convolution algorithm "
            "inside a capture than eagerly, and the bf16 convs round their sums in its order")
    on_card = device.type == "cuda"
    replay = _events_ms(hook.program, GRAPH_TIMED) if on_card else float("nan")
    eager = timer(lambda: hook.forward(model))
    model.train()
    log(f"graphs, the eval hook ({smi}): the program's outputs equal its eager body's "
        f"{'bit for bit' if same else f'within {max(rel):.3g} of max'} on the default "
        f"path's weights; launches {launches}; the forward {replay:.3f} ms replayed, "
        f"{eager:.3f} ms eager (CUDA events); the calls: "
        + "; ".join(f"{'capture' if i == 0 else 'replay'} {hook_split(t)}"
                    for i, t in enumerate(splits)))
    return [("eval hook forward (16 frames, 15 pairs, a snippet)", eager, replay)]


# The demo's 4000 steps and the full-colon run's 3,000 frames, cut for time.
# Its corpus (8 × 64 frames, 496 snippets) gives 41 steps an epoch at B=12,
# so the hook fires at steps 123, 246 and 369: a capture and two replays.
DEMO_STEPS, DEMO_EVAL_EPOCHS = 400, 3
DEMO_LOSS_WINDOW = 20  # the mean total of the last steps must be below the first steps'
FULLCOLON_FRAMES = 600


def demo_phase(device, smi: str, out: str) -> tuple:
    """The port's demo (``colvo_torch.scripts.demo_synthetic.main``) at full
    width for ``DEMO_STEPS`` steps with the eval hook every
    ``DEMO_EVAL_EPOCHS`` epochs, into ``out``: every step's total loss
    finite (copied from the step's outputs on the card) and the mean of the
    last ``DEMO_LOSS_WINDOW`` below the first's; the hook's three calls on
    one program, their ``eval/*`` rows finite and their panels written;
    the launches the steps' (warm-up and replays); the exported weights
    loaded by ``make_runner``; ``evaluate_synthetic``'s metrics finite and
    its three figures on disk. Logs ms/step, the interval between steps,
    the hook's calls and the Abs-Rel reached. Returns (launches, the
    weights' path)."""
    from colvo_torch import pipelines
    from colvo_torch.scripts import demo_synthetic as demo

    t_phase = time.time()
    cfg = ColvoConfig()
    totals, starts, calls = [], [], []
    real_hook = demo.make_training_eval_hook

    def recorded_hook(cfg_, model):
        hook = real_hook(cfg_, model)

        def call(step, state, writer):
            t_ns = time.perf_counter_ns()
            scalars = hook(step, state, writer)
            calls.append((step, eval_calls(t_ns)[0], hook.program))
            return scalars
        return call

    def recorded(step_fn):
        def step(*args):
            starts.append(time.perf_counter())
            metrics = step_fn(*args)
            totals.append(metrics["loss/total"].clone())  # the next replay overwrites it
            return metrics
        return step

    reset_launch_counts()
    with wrap_step_fns(recorded), mock.patch.object(demo, "make_training_eval_hook",
                                                    recorded_hook):
        metrics = demo.main(DEMO_STEPS, out, device.type, eval_every_epochs=DEMO_EVAL_EPOCHS)
    counts = launch_counts()
    total = torch.stack(totals).cpu().numpy()
    first, last = total[:DEMO_LOSS_WINDOW].mean(), total[-DEMO_LOSS_WINDOW:].mean()
    check(len(total) == DEMO_STEPS and np.isfinite(total).all() and last < first,
          f"the demo's {len(total)} step losses finite, the last {DEMO_LOSS_WINDOW}'s mean "
          f"{last:.6g} below the first {DEMO_LOSS_WINDOW}'s {first:.6g}")
    want = dict(Counter(step_launches(cfg, DEMO_STEPS + STEP_WARMUP))
                + Counter(eval_hook_launches(cfg, len(calls))))
    check(counts == want, f"demo launches {counts} == {want}")
    with open(os.path.join(out, "train", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if "eval/abs_rel" in r]
    offsets = cfg.data.frame_offsets
    snippets = demo.N_SEQUENCES * (demo.N_FRAMES - max(0, *offsets) + min(0, *offsets))
    every = snippets // cfg.data.batch_size * DEMO_EVAL_EPOCHS
    hook_steps = list(range(every, DEMO_STEPS + 1, every))
    check(len(hook_steps) >= 2
          and [r["step"] for r in evals] == hook_steps == [c[0] for c in calls]
          and all(np.isfinite(v) for r in evals for v in r.values())
          and all(c[2] is calls[0][2] for c in calls) and len(calls[0][2].programs) == 1,
          f"the hook at steps {hook_steps}, one program, finite eval rows: {evals}")
    for step in hook_steps:
        for tag in ("disp", "automask", "warp_error"):
            shape = _png_shape(os.path.join(out, "train", f"panels_{tag}_{step:08d}.png"))
            check(shape == (cfg.data.height, cfg.data.width, 3), f"demo panel {tag} {shape}")
    losses = [r for r in rows if "loss/total" in r]
    check([r["step"] for r in losses] == [DEMO_STEPS]
          and all(np.isfinite(v) for r in losses for v in r.values()), f"loss rows {losses}")
    weights = os.path.join(out, "weights.npz")
    runner = pipelines.make_runner(cfg, weights, device)
    frame = np.full((1, cfg.data.height, cfg.data.width, 3), 0.5, np.float32)
    check(np.isfinite(runner.infer_depth(frame)[0]).all(), "the exported weights infer")
    check(all(np.isfinite(v) for v in metrics.values()) and "polyp/e_mean" in metrics,
          f"evaluate_synthetic metrics {metrics}")
    for name in ("qualitative_depth.png", "trajectory_predictions.png",
                 "colon_reconstruction.png"):
        check(len(_png_shape(os.path.join(out, "eval", name))) == 3, f"demo figure {name}")
    wall = [r for r in rows if "wall_steps_per_sec" in r][0]["wall_steps_per_sec"]
    gaps = np.diff(starts) * 1e3
    log(f"demo ({smi}): {DEMO_STEPS} steps on the device loader at full width, "
        f"{1e3 / wall:.2f} ms/step (wall_steps_per_sec: the steps after the first, "
        f"the hook's three calls and the final checkpoint included); a step started every "
        f"{np.median(gaps[1:]):.2f} ms (median of steps 3-{DEMO_STEPS}); total loss "
        f"{first:.6g} (mean of the first {DEMO_LOSS_WINDOW}) -> {last:.6g} (last "
        f"{DEMO_LOSS_WINDOW}); launches {counts}")
    log("demo: the eval hook's calls: " + "; ".join(
        f"step {st} ({'capture' if i == 0 else 'replay'}) {hook_split(t)}, abs_rel "
        f"{r['eval/abs_rel']:.4f}, ate {r['eval/ate']:.6g}"
        for i, ((st, t, _), r) in enumerate(zip(calls, evals))))
    log("demo: evaluate_synthetic on the exported weights: " + " ".join(
        f"{k}={v:.6g}" for k, v in metrics.items()))
    log(f"demo phase: {time.time() - t_phase:.1f} s")
    return counts, weights


def fullcolon_phase(device, smi: str, weights: str, out: str) -> Counter:
    """The port's full-colon run (``colvo_torch.scripts.fullcolon.main``) on
    the demo's weights at ``FULLCOLON_FRAMES`` frames with keyframe
    refinement on (it runs kernel S; the default leaves it off), its render
    cache in a temporary directory: finite ATE (before and after the
    refinement) and polyp errors, non-empty clouds for ours and for GT, the
    gzipped PLY's point count the record's, the figure written; the
    refinement's launches (its program's warm-up where this signature was
    not captured before, then a replay a batch). Logs the record and the
    VO frames/s. Returns the launches."""
    import gzip

    from colvo_torch.scripts import fullcolon
    from colvo_torch.vo import load_ply
    from colvo_torch.vo import refine as refine_mod

    t_phase = time.time()
    before = len(refine_mod._refine.programs)
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as cache, mock.patch.object(tempfile, "tempdir", cache):
        rec = fullcolon.main(FULLCOLON_FRAMES, weights, out, device.type, refine=True)
    counts = launch_counts()
    pairs = FULLCOLON_FRAMES // 10 - 1
    calls = -(-pairs // REFINE_BATCH) + STEP_WARMUP * (len(refine_mod._refine.programs) - before)
    want = refine_launches(calls)
    check(counts == want, f"full-colon launches {counts} == {want}")
    keys = ["ate", "raw/ate", "rpe_rot_deg", "polyp/e1", "polyp/e2", "polyp/e3", "polyp/e_mean"]
    check(all(np.isfinite(rec[k]) for k in keys) and rec["n_points_ours"] > 0
          and rec["n_points_gt"] > 0, f"full-colon record {rec}")
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "ours.ply")
        with gzip.open(os.path.join(out, "fullcolon_ours.ply.gz"), "rb") as f, \
                open(ply, "wb") as g:
            g.write(f.read())
        check(len(load_ply(ply).points) == rec["n_points_ours"], "the full-colon PLY")
    check(len(_png_shape(os.path.join(out, "fullcolon_recon.png"))) == 3, "full-colon figure")
    log(f"full-colon ({smi}): {FULLCOLON_FRAMES} frames, {rec['fps']} frames/s VO (uint8 wire, "
        f"symmetric pose, chunks of 32; warm-up {rec['compile_s_excluded']} s excluded); ATE "
        f"{rec['raw/ate']} before the refinement, {rec['ate']} after ({rec['refine/refine_s']} "
        f"s, {rec['refine/pairs']} pairs); polyp e {rec['polyp/e1']} / {rec['polyp/e2']} / "
        f"{rec['polyp/e3']} (mean {rec['polyp/e_mean']}); clouds ours {rec['n_points_ours']} / "
        f"GT {rec['n_points_gt']} points; launches {counts}")
    log(f"full-colon phase: {time.time() - t_phase:.1f} s")
    return Counter(counts)


# The ablation's cells (4000 steps on 8 × 64 frames) and the long video's
# 3,000 frames, cut for time.
ABLATE_STEPS = 60
ABLATE_CORPUS = (2, 16)  # sequences × frames: 28 snippets, 2 steps an epoch at B=12
ABLATE_CELLS = (dict(dcdp=True, lcc=True),
                dict(dcdp=True, lcc=True, exp_jitter=0.35, lcc_mode="global+affine",
                     name="expjit_dcdp1_lccG"))
# the reference's record (scripts/ablate.py): the cell, then evaluate_synthetic's metrics
ABLATE_KEYS = ("cell", "seed", "dcdp", "lcc", "steps", "train_s", "abs_rel", "sq_rel", "rmse",
               "rmse_log", "a1", "a2", "a3", "ate", "rpe_trans", "rpe_rot_deg", "rpe_trans_5",
               "rpe_rot_deg_5", "polyp/e1", "polyp/e2", "polyp/e3", "polyp/e_mean")
ABLATE_PEAK_RATIO = 1.1  # a later cell's peak memory against the first's
# The restart cell's check, of ABLATE_STEPS (1500 of 4000 uncut), and its
# restart_max: 1 in place of 2. On the H100 (restart_probe) the first
# attempt's loss/geometric at step 3 came out 0.0695-0.0696 in each of 7
# runs, far over the cell's threshold (0.015), so it restarts; the second
# attempt's varied from 0.041 to 0.083 between runs (Adam's first updates
# turn the float atomics' rounding into full-size steps) and passed the
# first's in one run; at steps 1, 2, 5 and 20 it passed it in every run,
# at step 10 it came within 6 %. No threshold can then rule out a second
# restart; with restart_max 1 the second attempt is the last, which runs
# to its end.
RESTART_CHECK_STEP = 3
LONGVIDEO_FRAMES = 300
# Host RSS over a stream, max - min: it grows once inside the stream, by
# 102-210 MB at 300 frames and at 3,000 alike on the H100 (not O(N), whose
# depth maps alone would add ~25 MB as uint8 every 300 frames).
LONGVIDEO_RSS_MB = 300.0


def ablate_phase(device, smi: str, root: str) -> Counter:
    """``ablate.run_cell`` for ``ABLATE_CELLS`` at full width, ``ABLATE_STEPS``
    steps on the corpus cut to ``ABLATE_CORPUS``, into ``root``: each cell's
    launches exactly its steps' and the warm-up's, a finite record with the
    reference's keys, its peak memory (the second within
    ``ABLATE_PEAK_RATIO`` of the first: a finished cell gives back its
    programs); a resumed cell returns its record and launches nothing;
    ``ABLATION.md`` has the two rows. Logs ms/step and the seconds of
    rendering, training and evaluation. Returns the launches."""
    from colvo_torch.scripts import ablate

    t_phase = time.time()
    stages, cfgs = Counter(), []

    def timed_stage(key, fn):
        def run(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                stages[key] += time.time() - t0
        return run

    real_train = ablate.train_loop

    def recorded_train(cfg, *args, **kwargs):
        cfgs.append(cfg)
        return real_train(cfg, *args, **kwargs)

    total, recs, peaks, before = Counter(), [], [], []
    with mock.patch.object(ablate, "N_SEQUENCES", ABLATE_CORPUS[0]), \
            mock.patch.object(ablate, "N_FRAMES", ABLATE_CORPUS[1]), \
            mock.patch.object(ablate, "corpus", timed_stage("render", ablate.corpus)), \
            mock.patch.object(ablate, "train_loop", timed_stage("train", recorded_train)), \
            mock.patch.object(ablate, "evaluate_synthetic",
                              timed_stage("evaluate", ablate.evaluate_synthetic)):
        for cell in ABLATE_CELLS:
            stages.clear()
            torch.cuda.synchronize(device)
            before.append(torch.cuda.memory_allocated(device) / 2**30)
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            t0 = time.time()
            rec = ablate.run_cell(steps=ABLATE_STEPS, out_root=root, device=device.type, **cell)
            cell_s = time.time() - t0
            counts = launch_counts()
            peaks.append(torch.cuda.max_memory_allocated(device) / 2**30)
            want = step_launches(cfgs[-1], ABLATE_STEPS + STEP_WARMUP)
            check(counts == want, f"ablation cell {rec['cell']}: launches {counts} == {want}")
            total.update(counts)
            check(tuple(rec) == ABLATE_KEYS and all(
                np.isfinite(v) for k, v in rec.items() if k not in ("cell", "dcdp", "lcc")),
                f"ablation record {rec}")
            recs.append(rec)
            with open(os.path.join(root, rec["cell"], "train", "metrics.jsonl")) as f:
                wall = [json.loads(line) for line in f if "wall_steps_per_sec" in line]
            log(f"ablation cell {rec['cell']} ({smi}): {ABLATE_STEPS} steps at "
                f"{1e3 / wall[-1]['wall_steps_per_sec']:.2f} ms/step (wall_steps_per_sec: the "
                f"steps after the first, the checkpoint inside); {cell_s:.1f} s: render "
                f"{stages['render']:.1f}, train {stages['train']:.1f}, evaluate "
                f"{stages['evaluate']:.1f}; {before[-1]:.2f} GiB allocated before, peak "
                f"{peaks[-1]:.2f} GiB; launches {counts}; abs_rel {rec['abs_rel']} ate "
                f"{rec['ate']} rpe_rot_deg {rec['rpe_rot_deg']} polyp/e_mean "
                f"{rec['polyp/e_mean']}")
        reset_launch_counts()
        again = ablate.run_cell(steps=ABLATE_STEPS, out_root=root, device=device.type,
                                **ABLATE_CELLS[0])
        check(again == recs[0] and launch_counts() == {},
              f"a resumed cell returns its record ({again == recs[0]}) and launches nothing "
              f"({launch_counts()})")
        check(peaks[1] <= ABLATE_PEAK_RATIO * peaks[0],
              f"the second cell's peak {peaks[1]:.3f} GiB within {ABLATE_PEAK_RATIO}x the "
              f"first's {peaks[0]:.3f}")
        rec, counts, peak = restart_cell(device, smi, root, cfgs[0], peaks[0])
        total.update(counts)
        recs.append(rec)
        peaks.append(peak)
    ablate.aggregate(root, ABLATE_STEPS)
    with open(os.path.join(root, "ABLATION.md")) as f:
        rows = [line for line in f if line.startswith("| ") and "seeds (conv" not in line]
    check(sorted(r[2:].split(" |")[0].split(" ⚠")[0] for r in rows)
          == sorted(r["cell"] for r in recs), f"ABLATION.md rows {rows}")
    log(f"ablation phase: {time.time() - t_phase:.1f} s; peaks " + " / ".join(
        f"{p:.3f}" for p in peaks) + " GiB; ABLATION.md rows: " + " ".join(r.strip() for r in rows))
    return total


def restart_spec() -> dict:
    """``gauge_validate``'s restart cell (``dcdp1_lcc1_restart``, seed 1234)."""
    from colvo_torch.scripts import gauge_validate

    return next(c for c in gauge_validate.gauge_cells(requeue=True)
                if c.get("name") == "dcdp1_lcc1_restart")


def restart_probe(device, base: ColvoConfig, check_step: int) -> list:
    """The restart cell's ``train.restart_metric`` at ``check_step`` of its
    first two attempts: a run of its config (``base``, the first ablation
    cell's, with its seed and overrides) whose threshold every attempt
    exceeds (two restarts, then a last attempt of ``check_step`` steps).
    Not called by ``main``: the measurement behind ``RESTART_CHECK_STEP``
    (call it inside ``ablate_phase``'s cut corpus, e.g. by patching
    ``restart_cell``)."""
    from colvo_torch.scripts import ablate

    cell = restart_spec()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = copy.deepcopy(base)
        cfg.train.seed = cell["seed"]
        for dotted, v in cell["overrides"].items():
            sect, attr = dotted.split(".")
            setattr(getattr(cfg, sect), attr, v)
        cfg.train.restart_check_step, cfg.train.restart_threshold = check_step, 1e-12
        cfg.train.ckpt_dir = os.path.join(tmp, "ckpt")
        ablate.train_loop(cfg, ablate.corpus(cfg, 0.0), log_dir=tmp, max_steps=check_step,
                          device=device)
        ablate.release(device)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            return [json.loads(line)["restart/metric_value"] for line in f
                    if "restart/attempt" in line]


def restart_cell(device, smi: str, root: str, base: ColvoConfig, first_peak: float) -> tuple:
    """The restart cell through ``ablate.run_cell`` into ``root``, with two
    of its overrides changed: the check at ``RESTART_CHECK_STEP`` and
    ``train.restart_max`` 1 (see ``RESTART_CHECK_STEP``). ``base`` is the
    first cell's training config (the same loss path). Checks one restart
    to the new seed at the check step, launches exactly both attempts'
    steps and warm-ups, weights moved away from the new seed's init, the
    peak within ``ABLATE_PEAK_RATIO`` of ``first_peak``. Returns the
    record, its launches and its peak GiB. Run inside ``ablate_phase``'s
    cut corpus."""
    from colvo_torch.models import ColVOModel
    from colvo_torch.runtime import load_npz
    from colvo_torch.scripts import ablate

    cell = restart_spec()
    seed = cell["seed"]
    overrides = dict(cell["overrides"], **{"train.restart_check_step": RESTART_CHECK_STEP,
                                           "train.restart_max": 1})
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.time()
    rec = ablate.run_cell(steps=ABLATE_STEPS, out_root=root, device=device.type,
                          **dict(cell, overrides=overrides))
    cell_s = time.time() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    cell_dir = os.path.join(root, f"{cell['name']}_s{seed}")
    with open(os.path.join(cell_dir, "train", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    restarts = [r for r in rows if "restart/attempt" in r]
    check(len(restarts) == 1 and restarts[0]["restart/new_seed"] == seed + 1000
          and restarts[0]["step"] == RESTART_CHECK_STEP,
          f"restart cell: one restart at step {RESTART_CHECK_STEP} to seed {seed + 1000}: "
          f"{restarts}")
    want = step_launches(base, RESTART_CHECK_STEP + ABLATE_STEPS + 2 * STEP_WARMUP)
    check(counts == want, f"restart cell: launches {counts} == {want} (both attempts' steps "
          "and warm-ups)")
    check(tuple(rec) == ABLATE_KEYS and all(
        np.isfinite(v) for k, v in rec.items() if k not in ("cell", "dcdp", "lcc")),
        f"restart cell record {rec}")
    weights = load_npz(os.path.join(cell_dir, "weights.npz"), base.model)
    init = ColVOModel(base.model)
    init.reset_parameters(torch.Generator().manual_seed(seed + 1000))
    same = [k for k, v in init.state_dict().items() if torch.equal(v, weights[k].to(v.dtype))]
    check(same == [], f"restart cell: tensors still at the new seed's init: {same}")
    check(peak <= ABLATE_PEAK_RATIO * first_peak,
          f"restart cell: peak {peak:.3f} GiB within {ABLATE_PEAK_RATIO}x the first cell's "
          f"{first_peak:.3f}")
    wall = [r for r in rows if "wall_steps_per_sec" in r]
    log(f"restart cell {rec['cell']} seed {seed} ({smi}): restarted once at step "
        f"{restarts[0]['step']} ({base.train.restart_metric} "
        f"{restarts[0]['restart/metric_value']:.6g} > {overrides['train.restart_threshold']}), then "
        f"{ABLATE_STEPS} steps at {1e3 / wall[-1]['wall_steps_per_sec']:.2f} ms/step; "
        f"{cell_s:.1f} s; peak {peak:.3f} GiB; launches {counts}; abs_rel {rec['abs_rel']} "
        f"rpe_rot_deg {rec['rpe_rot_deg']}")
    return rec, Counter(counts), peak


def studies_phase(device, smi: str, root: str, out: str) -> None:
    """``figures``, ``scale_decoupling`` and ``gauge_probe`` over the
    ablation phase's cells under ``root`` (``<tmp>/runs/ablate``, so that
    the probe reads its ``RUNS``): two methods drawn (two PNGs), finite
    rows for the two cells and the other runs skipped, no kernel
    launched."""
    from colvo_torch.scripts import figures, gauge_probe, scale_decoupling

    t_phase = time.time()
    reset_launch_counts()
    preds, trajs = figures.main(root, os.path.join(out, "figures"), device.type)
    check(list(preds) == ["ColVO(ours)", "expjit-trained LCC-global"]
          and all(np.isfinite(v).all() for v in (*preds.values(), *trajs.values())),
          f"figures' methods {list(preds)}")
    for name in ("qualitative_depth_methods.png", "trajectories_methods.png"):
        check(len(_png_shape(os.path.join(out, "figures", name))) == 3, f"figure {name}")
    rows = scale_decoupling.main(root, None, device.type)
    check([r["run"] for r in rows] == ["expjit_dcdp1_lccG", "dcdp1_lcc1"]
          and all(np.isfinite([r["s_traj"], r["s_depth"], r["decoupling"], r["polyp_e_mean"]]).all()
                  for r in rows)
          and os.path.exists(os.path.join(root, "SCALE_DECOUPLING.md")),
          f"scale_decoupling rows {rows}")
    with contextlib.chdir(os.path.dirname(os.path.dirname(root))):
        probe = gauge_probe.main("runs/ablate", 12, device.type)
    done = [r for r in probe if "skip" not in r]
    check([r["run"] for r in done] == ["expjit_dcdp1_lccG", "dcdp1_lcc1"]
          and len(probe) == len(gauge_probe.RUNS)
          and all(np.isfinite([v for k, v in r.items() if k != "run"]).all() for r in done),
          f"gauge_probe lines {probe}")
    check(launch_counts() == {}, f"the studies launch no kernel: {launch_counts()}")
    log(f"studies ({smi}): figures of {list(preds)}; scale_decoupling {rows}; gauge_probe "
        f"{done}; {time.time() - t_phase:.1f} s")


DRIFT_FRAMES = 98  # 97 pairs: three batches of 32 and one padded (600 frames uncut)
# 2 arms × 2 sources, one warp of 31 frames each; L: each warp's and each
# calibrated identity's global+affine LCC; E: each warp's error and each
# identity's, raw and calibrated
EXPJIT_MECHANISM_LAUNCHES = {"S/value/C3": 4, "L/affine": 8, "E/fwd/C3": 12}


def analysis_with_peaks(device, root: str, out_dir: str) -> tuple:
    """``expjit_analysis.main`` with each cell's peak device memory (GiB,
    its runner and evaluation, read after the cell gives its programs
    back). Returns the rows and the peaks."""
    from colvo_torch.scripts import expjit_analysis

    peaks, real_release = [], expjit_analysis.release

    def release(dev):
        real_release(dev)
        peaks.append(torch.cuda.max_memory_allocated(device) / 2**30)
        torch.cuda.reset_peak_memory_stats(device)

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    with mock.patch.object(expjit_analysis, "release", release):
        rows = expjit_analysis.main(root, out_dir, device.type)
    return rows, peaks


def expjit_drift_phase(device, smi: str, root: str, out: str) -> Counter:
    """The README's last three studies over the ablation phase's cells under
    ``root``: ``drift_audit`` on ``dcdp1_lcc1`` at ``DRIFT_FRAMES`` frames
    (finite statistics, bias fractions in [0, 1], one pose program for the
    padded tail); ``expjit_analysis`` at 48 frames (the two cells' rows
    finite, four maps, the other two cells skipped, the second cell's peak
    within ``ABLATE_PEAK_RATIO`` of the first's); ``expjit_mechanism`` on
    ``expjit_dcdp1_lccG``'s weights at 33 frames (H1-H4 finite, the clean
    arm's H2 None). Only the mechanism launches, exactly
    ``EXPJIT_MECHANISM_LAUNCHES``. Logs each script's seconds; returns the
    launches."""
    from colvo_torch.runtime import infer
    from colvo_torch.scripts import drift_audit, expjit_analysis, expjit_mechanism

    t_phase = time.time()
    secs = {}
    runners, real_make = [], drift_audit.make_runner

    def kept(*args, **kwargs):
        runners.append(real_make(*args, **kwargs))
        return runners[-1]

    reset_launch_counts()
    t0 = time.time()
    with mock.patch.object(drift_audit, "make_runner", kept):
        drift = drift_audit.main(DRIFT_FRAMES, os.path.join(root, "dcdp1_lcc1", "weights.npz"),
                                 os.path.join(out, "DRIFT.md"), device.type)
    secs["drift_audit"] = time.time() - t0
    programs = len(runners[0].program(infer._pose_body).programs)
    del runners[:]
    check(launch_counts() == {}, f"drift_audit launches nothing: {launch_counts()}")
    arms = (drift["forward"], drift["symmetrized"])
    check(drift["n_frames"] == DRIFT_FRAMES and programs == 1
          and all(np.isfinite([a["mean_norm_deg"], a["norm_mean_deg"], a["bias_fraction"],
                               *a["mean_axis"]]).all() and 0.0 <= a["bias_fraction"] <= 1.0
                  for a in arms) and np.isfinite(drift["fwd_plus_rev_rot_deg"]),
          f"drift_audit at {DRIFT_FRAMES} frames ({programs} pose programs): {drift}")
    check(os.path.exists(os.path.join(out, "DRIFT.md")), "DRIFT.md written")

    t0 = time.time()
    rows, peaks = analysis_with_peaks(device, root, os.path.join(out, "expjit"))
    secs["expjit_analysis"] = time.time() - t0
    check(launch_counts() == {}, f"expjit_analysis launches nothing: {launch_counts()}")
    maps = sorted(os.listdir(os.path.join(out, "expjit", "maps")))
    check([r["cell"] for r in rows] == ["dcdp1_lcc1", "expjit_dcdp1_lccG"]
          and all(np.isfinite([r[arm][k] for arm in ("clean", "expjit")
                               for k in expjit_analysis.KEYS]).all() for r in rows)
          and maps == sorted(f"{r['cell']}_{arm}.png" for r in rows
                             for arm in ("clean", "expjit"))
          and all(len(_png_shape(os.path.join(out, "expjit", "maps", m))) == 3 for m in maps)
          and os.path.exists(os.path.join(out, "expjit", "EXPJIT_DEPTH.md")),
          f"expjit_analysis rows {rows}, maps {maps}")
    check(len(peaks) == 2 and peaks[1] <= ABLATE_PEAK_RATIO * peaks[0],
          f"expjit_analysis: the second cell's peak within {ABLATE_PEAK_RATIO}x the first's: "
          f"{peaks} GiB")

    t0 = time.time()
    mech = expjit_mechanism.main(os.path.join(root, "expjit_dcdp1_lccG", "weights.npz"),
                                 os.path.join(out, "expjit", "EXPJIT_MECHANISM.md"), device.type)
    secs["expjit_mechanism"] = time.time() - t0
    counts = launch_counts()
    check(counts == EXPJIT_MECHANISM_LAUNCHES,
          f"expjit_mechanism launches {counts} == {EXPJIT_MECHANISM_LAUNCHES}")
    check(list(mech) == ["clean", "jittered"] and mech["clean"]["sel_gain_frac_mean"] is None
          and all(np.isfinite([v for k, v in a.items()
                               if not (arm == "clean" and k == "sel_gain_frac_mean")]).all()
                  for arm, a in mech.items()),
          f"expjit_mechanism {mech}")
    log(f"expjit and drift ({smi}): drift_audit at {DRIFT_FRAMES} frames bias_fraction "
        f"{drift['forward']['bias_fraction']:.4f} forward / "
        f"{drift['symmetrized']['bias_fraction']:.4f} symmetrized, "
        f"{drift['forward']['norm_mean_deg']:.4f} / {drift['symmetrized']['norm_mean_deg']:.4f} "
        f"deg a frame; expjit_analysis {rows}, peaks {peaks} GiB; expjit_mechanism {mech}; "
        f"launches {counts}; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    log(f"expjit and drift phase: {time.time() - t_phase:.1f} s")
    return Counter(counts)


def longvideo_phase(device, smi: str, root: str, out: str) -> None:
    """``longvideo.main`` for the clean arm on ``dcdp1_lcc1``'s weights and
    the expjit arm on ``expjit_dcdp1_lccG``'s, ``LONGVIDEO_FRAMES`` frames
    each, the render cache in a temporary directory: finite drift curves,
    host RSS flat within ``LONGVIDEO_RSS_MB``, the device's peak memory
    recorded, no kernel launched; the report names both arms and the card,
    its figure is the reference's 990 × 374. Logs frames/s and the renorm
    A/B."""
    from colvo_torch.scripts import longvideo

    t_phase = time.time()
    recs = []
    with tempfile.TemporaryDirectory() as cache, mock.patch.object(tempfile, "tempdir", cache):
        for arm, cell in (("clean", "dcdp1_lcc1"), ("expjit", "expjit_dcdp1_lccG")):
            reset_launch_counts()
            rec = longvideo.main(LONGVIDEO_FRAMES, os.path.join(root, cell, "weights.npz"), out,
                                 arm, None, device.type)
            check(launch_counts() == {}, f"long video {arm}: launches {launch_counts()}")
            rows = rec["curves"]["renorm50"] + rec["curves"]["renorm0"]
            check(all(np.isfinite([v for v in r.values()]).all() for r in rows)
                  and rec["rss_mb_max"] - rec["rss_mb_min"] <= LONGVIDEO_RSS_MB
                  and rec["device"] == torch.cuda.get_device_name(device)
                  and (rec["device_peak_mb"] or 0) > 0,
                  f"long video {arm}: {rec}")
            deltas = [abs(a[k] - b[k]) for a, b in zip(rec["curves"]["renorm50"],
                                                       rec["curves"]["renorm0"])
                      for k in longvideo.RENORM_KEYS[1:]]
            log(f"long video {arm} ({smi}): {LONGVIDEO_FRAMES} frames at {rec['fps']} frames/s "
                f"({rec['stream_s']} s; render {rec['render_s']} s outside); renorm50 "
                f"{rec['curves']['renorm50']}; renorm A/B max |delta| {max(deltas):.3e}; host RSS "
                f"{rec['rss_mb_min']}-{rec['rss_mb_max']} MB; device {rec['device_mb_before']} MB "
                f"before, peak {rec['device_peak_mb']} MB over the stream")
            recs.append(rec)
    with open(os.path.join(out, "LONGVIDEO.md")) as f:
        md = f.read()
    check(md.count(" arm (") == 2 and torch.cuda.get_device_name(device) in md,
          "LONGVIDEO.md names both arms and the card")
    shape = _png_shape(os.path.join(out, "longvideo_drift.png"))
    check(shape == (374, 990, 3), f"the drift figure {shape}")
    log(f"long-video phase: {time.time() - t_phase:.1f} s")


# Adam7's seven passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def adam7_png(rgb: np.ndarray) -> bytes:
    """An Adam7-interlaced 8-bit RGB PNG of (H, W, 3) uint8 ``rgb``, each
    pass's rows filtered with type r % 5 (None, Sub, Up, Average, Paeth),
    as the CPU test's writer does (neither cv2 nor PIL writes one)."""
    from colvo_torch.data import png

    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = rgb[y0::dy, x0::dx]
        if sub.size == 0:
            continue  # an empty pass has no bytes at all
        prev = np.zeros(sub.shape[1] * 3, np.int64)
        for r, cur in enumerate(sub.reshape(sub.shape[0], -1).astype(np.int64)):
            left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
            upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            pred = (np.zeros_like(cur), left, prev, (left + prev) // 2, paeth)[r % 5]
            raw += bytes([r % 5]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
            prev = cur
    h, w = rgb.shape[:2]
    return (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))


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
    ("P5/det", "bilinear_scatter_multi_det[C=1,4 scales,fixed point]",
     "colvo_torch/kernels/csrc/scatter.cu", "colvo/kernels/scatter.py:217", "T/C1/det"),
    ("P6", "bilinear_sample[grad,C=3,group=4]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:658", "S/grad/C3/g4"),
    ("P7", "fused_err[fwd,C=3,L=15]", "colvo_torch/kernels/csrc/fused_loss.cu",
     "colvo/kernels/fused_loss.py:275", "F/fwd/C3"),
    ("P8", "fused_err[bwd,C=3,L=15]", "colvo_torch/kernels/csrc/fused_loss.cu",
     "colvo/kernels/fused_loss.py:312", "F/bwd/C3"),
    ("P/fwd", "project_depth[fwd,S=2,12x256x320]", "colvo_torch/kernels/csrc/project.cu",
     "none: XLA's in the JAX package", "P/fwd"),
    ("P/bwd", "project_depth[bwd,S=2,12x256x320]", "colvo_torch/kernels/csrc/project.cu",
     "none: XLA's in the JAX package", "P/bwd"),
    ("L", "lcc_window[affine,C=3,L=15,12x256x320]", "colvo_torch/kernels/csrc/lcc.cu",
     "none: XLA's reduce_window in the JAX package", "L/affine"),
    ("E/fwd", "ssim_err[fwd,C=3,12x256x320]", "colvo_torch/kernels/csrc/ssim.cu",
     "none: XLA's reduce_window in the JAX package", "E/fwd/C3"),
    ("E/bwd", "ssim_err[bwd,C=3,12x256x320]", "colvo_torch/kernels/csrc/ssim.cu",
     "none: XLA's reduce_window in the JAX package", "E/bwd/C3"),
    ("FA/fwd", "factor_attention[fwd,a step's 38 calls,36 frames,d=8..36]",
     "colvo_torch/kernels/csrc/factor_attention.cu",
     "none: MPViT (no JAX counterpart); a softmax and two einsums in plain PyTorch", "FA/fwd"),
    ("FA/bwd", "factor_attention[bwd,a step's 38 calls,36 frames,d=8..36]",
     "colvo_torch/kernels/csrc/factor_attention.cu",
     "none: MPViT (no JAX counterpart); a softmax and two einsums in plain PyTorch", "FA/bwd"),
) + tuple(
    (f"A/{kind}/{label}", f"adam_{kind}[{config}'s parameters]", "colvo_torch/kernels/csrc/adam.cu",
     "none: optax's clip and Adam, which XLA fuses, in the JAX package", f"A/{kind}")
    for label, config in ADAM_LISTS for kind in ("sumsq", "clip", "step"))

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
        state, metrics, path_counts, step_ms[label], dispatch_ms[label], prof = slice_phase(
            cfg, device, batches)
        if label == "default":
            default_prof = prof
        expect = expected_launches(cfg, TRAIN_STEPS)
        check(path_counts == expect, f"{label} launch counts {path_counts} == {expect}")
        counts.update(path_counts)
        first[label] = metrics[0]
        if label == "default":
            serving_phase(cfg, state, device)
            _, refine_inputs = vo_phase(cfg, state, device, smi)
            serve_weights = {k: v.detach().cpu().clone()
                             for k, v in state.model.state_dict().items()}
        else:
            for k, v in first["default"].items():
                check(k == "grad_norm" or abs(first[label][k] - v) <= 1e-3 * max(abs(v), 1e-6),
                      f"step 1 {k}: {label} {first[label][k]} vs default {v}")
            log(f"step 1, {label} vs default: " + " ".join(
                f"{k} {first[label][k]:.6g}/{v:.6g}" for k, v in first["default"].items()))
        del state  # the next path's peak memory holds its own state only
    log("train ms/step (median of steps 2.., CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in step_ms.items()))
    log("--- MPViT: a default step's launches, the depthwise convolutions' kernels ---")
    counts.update(mpvit_phase(device, batches[0]))
    log("--- knobs: the off-default training configurations ---")
    counts.update(knob_phase(device, smi, batches, first["default"], step_ms["default"],
                             default_prof))
    log("--- deterministic: T's fixed-point variant, two cli train runs bit for bit ---")
    det_kernel_rows, det_counts, det_ckpt = det_phase(device, smi)
    rows.update(det_kernel_rows)
    counts.update(det_counts)
    log("--- data parallel: one NCCL rank under torch.distributed.run, two gloo ranks ---")
    counts.update(dp_phase(device, smi, batches, first["default"], det_ckpt))
    log("--- loop: cli train, export, train --resume ---")
    loop_counts, dataset, loop_ms = loop_phase(device, smi, step_ms["default"],
                                               dispatch_ms["default"])
    counts.update(loop_counts)
    log("--- device loader: cli train data.loader=device, the store, the captured chunk ---")
    counts.update(device_loader_phase(device, smi, dataset, loop_ms, step_ms["default"],
                                      dispatch_ms["default"]))
    log("--- grain loader: cli train data.loader=grain, a resume bit for bit ---")
    counts.update(grain_phase(device, smi))
    log("--- serving CLI: infer, vo, recon, viz, eval, eval --data, import-torch ---")
    serving_cli_phase(device, smi, serve_weights)
    log("--- refine: keyframe pose refinement ---")
    counts.update(refine_phase(device, smi, refine_inputs))
    log("--- graphs: each captured program against its eager body ---")
    counts.update(graphs_phase(device, smi, serve_weights, batches, dataset, refine_inputs))
    with tempfile.TemporaryDirectory() as tmp:
        log(f"--- demo: the port's demo_synthetic, {DEMO_STEPS} steps ---")
        demo_counts, weights = demo_phase(device, smi, os.path.join(tmp, "demo"))
        counts.update(demo_counts)
        log(f"--- full colon: the port's fullcolon, {FULLCOLON_FRAMES} frames ---")
        counts.update(fullcolon_phase(device, smi, weights, os.path.join(tmp, "fullcolon")))
        ablate_root = os.path.join(tmp, "runs", "ablate")
        log(f"--- ablation: the port's ablate, {len(ABLATE_CELLS)} cells of {ABLATE_STEPS} "
            "steps ---")
        counts.update(ablate_phase(device, smi, ablate_root))
        log("--- studies: figures, scale_decoupling, gauge_probe on the cells ---")
        studies_phase(device, smi, ablate_root, tmp)
        log("--- expjit and drift: drift_audit, expjit_analysis, expjit_mechanism on the cells ---")
        counts.update(expjit_drift_phase(device, smi, ablate_root,
                                         os.path.join(tmp, "expjit_drift")))
        log(f"--- long video: both arms, {LONGVIDEO_FRAMES} frames ---")
        longvideo_phase(device, smi, ablate_root, os.path.join(tmp, "longvideo"))

    # Nothing of JAX came in, not even through a library the port imports.
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "colvo"))
    check(loaded == [], f"modules of JAX or colvo loaded: {loaded[:8]}")

    table = []
    for key, name, src, replaces, counter in KERNELS:
        r = rows[key]
        check(counts[counter] > 0, f"{name} ({counter}) launched on no main path")
        bound_ms, bound_by = r["bound"]
        cold = f", {r['cold_ms']:.4f} ms with a cold L2" if "cold_ms" in r else ""
        if "float_ms" in r:
            cold += f" (the float T {r['float_ms']:.4f} ms on the same inputs)"
        log(f"{name}: {r['ms']:.4f} ms on the device (CUDA graph){cold}, {r['eager_ms']:.4f} ms "
            f"eager through the wrapper; plain {r['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms")
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[counter], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("registers", "smem_bytes", "cluster") if k in r},
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of dp_phase
        dp_rank(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
