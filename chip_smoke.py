#!/usr/bin/env python3
"""GPU smoke test of ``colvo_torch`` (the PyTorch/CUDA port), run from the
repository root with one CUDA card: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the CUDA kernels from ``colvo_torch/kernels/csrc`` (one ``nvcc``
   per source, in parallel).
3. Kernel phase: at the training path's shapes, holds kernel S (bilinear
   sampler, with and without d/dx, d/dy; C=3 photometric and C=1 at the
   four geo scales) and kernel T (source-cotangent scatter) against their
   plain PyTorch versions on the card, and times kernel, plain version and
   the nearest single PyTorch call on the device (CUDA-graph replays
   between CUDA events), and the kernel's eager call through its wrapper.
4. Slice phase: the default ``ColvoConfig`` at full width (ResNet-18,
   B=12, 256×320, 3 frames, 4 scales, bf16 convs) trains for a few steps
   on rendered synthetic snippets, then evaluates the loss on a held-out
   batch without gradients. Losses and the gradient norm must be finite,
   the launch counters must show every S and T launch of the path, and
   step 1's loss terms must agree with a recomputation that swaps the
   kernels for their plain versions on the same weights and batch. One
   more step runs under ``torch.profiler``: device time by kernel and by
   bucket, the device's busy share, peak memory.
5. Serving phase: ``InferenceRunner.infer_coupled`` on frame pairs.
6. Prints the kernel table as one JSON line, then the device line
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails without a CUDA card, or where ``colvo_torch`` is absent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from colvo_torch.config import ColvoConfig  # noqa: E402
from colvo_torch.data import batch_iterator, synthetic_dataset  # noqa: E402
from colvo_torch.kernels import build, launch_counts, reset_launch_counts  # noqa: E402
from colvo_torch.kernels import sampler, scatter  # noqa: E402
from colvo_torch.runtime import InferenceRunner, init_state, loss_fn, to_device, train_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

PHOTO = (12, 3, 256, 320)  # B, C, H, W of the photometric warp
GEO_N = 24  # S·B depth planes of the stacked geo warp
GEO_SCALES = ((256, 320), (128, 160), (64, 80), (32, 40))
TOL_VALUE, TOL_GRAD, TOL_SCATTER_REL = 1e-5, 1e-4, 1e-4
TRAIN_STEPS = 6


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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()``: warmed up on a side stream, captured
    into a CUDA graph and replayed ``iters`` times between CUDA events, so
    Python dispatch stays out of the clock."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return _events_ms(graph.replay, iters)


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


def kernel_phase(device, photo=PHOTO, geo_n=GEO_N, geo_scales=GEO_SCALES, timed=True):
    """Hold S and T against their plain versions; returns the kernel rows
    (without launch counts) keyed P1..P5."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(0)
    timer = time_ms if timed else (lambda fn, **kw: float("nan"))
    eager = eager_ms if timed else (lambda fn, **kw: float("nan"))
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

    # Geo warp: C=1 depth planes at the four scales (P3, P4), scatter (P5).
    geo = []
    for i, (gh, gw) in enumerate(geo_scales):
        d = (0.01 + torch.rand((geo_n, 1, gh, gw), generator=gen)).to(device)
        gx, gy = make_coords(geo_n, gh, gw, 10 + i, device)
        g = torch.randn((geo_n, 1, gh, gw), generator=gen).to(device)
        g[:, :, : gh // 8] = 0.0  # zero cotangent where the loss masks pixels
        geo.append((d, gx, gy, g, _norm_grid(gx, gy, gh, gw)))
    errs = {"P3": 0.0, "P4": 0.0, "P5": 0.0}
    scatter_rel = 0.0
    for d, gx, gy, g, _ in geo:
        o, ddx, ddy = sampler.sample(d, gx, gy, True)
        po, pdx, pdy = sampler.sample_plain(d, gx, gy, True)
        errs["P3"] = max(errs["P3"], (o - po).abs().max().item(),
                         (ddx - pdx).abs().max().item(), (ddy - pdy).abs().max().item())
        check((o - po).abs().max().item() <= TOL_VALUE, "S geo value vs plain")
        check(max((ddx - pdx).abs().max().item(), (ddy - pdy).abs().max().item()) <= TOL_GRAD,
              "S geo d/dx, d/dy vs plain")
        vo = sampler.sample(d, gx, gy, False)[0]
        errs["P4"] = max(errs["P4"], (vo - po).abs().max().item())
        ds = scatter.scatter(gx, gy, g, *d.shape[2:])
        pds = scatter.scatter_plain(gx, gy, g, *d.shape[2:])
        err = (ds - pds).abs().max().item()
        errs["P5"] = max(errs["P5"], err)
        scatter_rel = max(scatter_rel, err / pds.abs().max().item())
        check(bool(torch.isfinite(ds).all()), "T finite")
    log(f"S geo C=1 x{len(geo)} scales: |value,dx,dy| {errs['P3']:.3g}  "
        f"|value-only| {errs['P4']:.3g};  T: |d_src| {errs['P5']:.3g}, "
        f"/ max|d_src| {scatter_rel:.3g}")
    check(errs["P4"] <= TOL_VALUE and scatter_rel <= TOL_SCATTER_REL, "S geo value-only, T vs plain")

    def all_scales(fn):
        return lambda: [fn(*t) for t in geo]

    geo_s_grad = all_scales(lambda d, gx, gy, g, gr: sampler.sample(d, gx, gy, True))
    geo_s_value = all_scales(lambda d, gx, gy, g, gr: sampler.sample(d, gx, gy, False))
    geo_t = all_scales(lambda d, gx, gy, g, gr: scatter.scatter(gx, gy, g, *d.shape[2:]))

    gpx = sum(t[1].numel() for t in geo)
    gsrc = sum(t[0].numel() for t in geo)
    rows["P3"] = dict(
        max_abs_err=errs["P3"],
        ms=timer(geo_s_grad),
        eager_ms=eager(geo_s_grad),
        plain_ms=timer(all_scales(lambda d, gx, gy, g, gr: sampler.sample_plain(d, gx, gy, True))),
        library_ms=None,
        bound=bound(4 * (gsrc + 5 * gpx), 23 * gpx),
    )
    rows["P4"] = dict(
        max_abs_err=errs["P4"],
        ms=timer(geo_s_value),
        eager_ms=eager(geo_s_value),
        plain_ms=timer(all_scales(lambda d, gx, gy, g, gr: sampler.sample_plain(d, gx, gy, False))),
        library_ms=timer(all_scales(
            lambda d, gx, gy, g, gr: F.grid_sample(d, gr, "bilinear", "border", True))),
        bound=bound(4 * (gsrc + 3 * gpx), 18 * gpx),
    )
    rows["P5"] = dict(
        max_abs_err=errs["P5"],
        ms=timer(geo_t),
        eager_ms=eager(geo_t),
        plain_ms=timer(all_scales(
            lambda d, gx, gy, g, gr: scatter.scatter_plain(gx, gy, g, *d.shape[2:]))),
        library_ms=timer(all_scales(
            lambda d, gx, gy, g, gr: torch.ops.aten.grid_sampler_2d_backward(
                g, d, gr, 0, 1, True, [True, False]))),
        bound=bound(4 * (3 * gpx + gsrc), 24 * gpx),
    )
    torch.backends.cudnn.allow_tf32 = True
    return rows


def slice_phase(cfg: ColvoConfig, device, n_steps: int = TRAIN_STEPS, n_frames: int = 24):
    """Default train steps at ``cfg``'s size + a held-out no-grad loss."""
    t0 = time.time()
    ds = synthetic_dataset(cfg.data, n_sequences=2, n_frames=n_frames)
    it = batch_iterator(ds, cfg.data, seed=0)
    batches = [to_device(next(it), device) for _ in range(n_steps + 1)]
    log(f"rendered {len(ds)} snippets at {cfg.data.height}x{cfg.data.width} "
        f"in {time.time() - t0:.1f} s")
    state = init_state(cfg, device=device)

    # Step 1's loss, recomputed with the plain samplers on the same weights.
    with torch.no_grad(), mock.patch.object(sampler, "sample", sampler.sample_plain), \
            mock.patch.object(scatter, "scatter", scatter.scatter_plain):
        _, ref_aux = loss_fn(state.model, batches[0], cfg)
    ref_aux = {k: v.item() for k, v in ref_aux.items()}

    reset_launch_counts()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              if device.type == "cuda" else None for _ in range(n_steps)]
    metrics = []
    for i in range(n_steps):
        if events[i]:
            events[i][0].record()
        metrics.append(train_step(state, batches[i], cfg))
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
    log(f"step 1 vs plain samplers: " + " ".join(
        f"{k} {metrics[0][k]:.6g}/{v:.6g}" for k, v in ref_aux.items()))
    log(f"held-out loss (no grad): {eval_loss.item():.6g}; launches: {counts}")
    if device.type == "cuda":
        busy = profile_step(state, batches[0], cfg)
        med = float(np.median(step_ms[1:]))
        log(f"train step: {med:.2f} ms/step (median of steps 2..{n_steps}, CUDA events; "
            f"all: {[round(t, 2) for t in step_ms]}); device busy {busy:.2f} ms of it "
            f"({100 * busy / med:.1f} %, kernel time of the profiled step)")
    return state, metrics, counts


# Kernel-name keywords of the buckets in the step breakdown, first match wins.
BUCKETS = (
    ("S (bilinear_sample)", ("bilinear_sample",)),
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


KERNELS = (
    ("P1", "bilinear_sample[grad,C=3]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:658", "S/grad/C3"),
    ("P2", "bilinear_sample[value,C=3]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:664", "S/value/C3"),
    ("P3", "bilinear_sample[grad,C=1,4 scales]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:700", "S/grad/C1"),
    ("P4", "bilinear_sample[value,C=1,4 scales]", "colvo_torch/kernels/csrc/sampler.cu",
     "colvo/kernels/sampler.py:706", "S/value/C1"),
    ("P5", "bilinear_scatter[C=1,4 scales]", "colvo_torch/kernels/csrc/scatter.cu",
     "colvo/kernels/scatter.py:217", "T/C1"),
)


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

    rows = kernel_phase(device)
    cfg = ColvoConfig()
    state, _, counts = slice_phase(cfg, device)
    n = TRAIN_STEPS
    expect = {"S/grad/C3": 8 * n, "S/grad/C1": 4 * n, "T/C1": 4 * n,
              "S/value/C3": 8, "S/value/C1": 4}
    check(counts == expect, f"launch counts {counts} == {expect}")
    serving_phase(cfg, state, device)

    table = []
    for key, name, src, replaces, counter in KERNELS:
        r = rows[key]
        bound_ms, bound_by = r["bound"]
        log(f"{name}: {r['ms']:.4f} ms on the device (CUDA graph), {r['eager_ms']:.4f} ms "
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
