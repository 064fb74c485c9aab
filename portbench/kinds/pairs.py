"""Live frame pairs: one client in a closed loop over
``InferenceRunner.infer_coupled``.

Parameters: ``pool_frames`` consecutive rendered frames, sent as float32
[0, 1] arrays of shape (1, H, W, 3), each call the pair (frame j, frame
j + 1) of the cycled pool; ``warm_calls`` calls of set-up (the capture);
``trace_calls`` traced after the window; ``check_calls`` calls kept for
the check, a uniform sample of the window's calls drawn from the seed
(reservoir sampling). Each call is timed on the host clock from the
request to the numpy results in hand.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Ctx, Outcome, free, sync
from portbench.kinds import serve


def run(ctx: Ctx) -> Outcome:
    cfg = ctx.colvo_config()
    marks = [("start", time.perf_counter())]
    runner, w = serve.runner(ctx, cfg)
    marks.append(("weights and runner", time.perf_counter()))
    frames_u8 = serve.pool(ctx, cfg)
    marks.append(("render", time.perf_counter()))
    frames = frames_u8.astype(np.float32) / 255.0
    p = len(frames)

    def pair(j):
        return frames[j % p][None], frames[(j + 1) % p][None]

    for j in range(int(ctx.param("warm_calls"))):
        runner.infer_coupled(*pair(j))
    sync(ctx.device)
    marks.append(("warm-up calls (capture)", time.perf_counter()))
    rng = np.random.default_rng(ctx.seed)
    keep_n = int(ctx.param("check_calls"))
    kept, lat = [], []
    sync(ctx.device)
    t0 = time.perf_counter()
    deadline, j = t0 + ctx.seconds, 0
    while True:
        a, b = pair(j)
        t = time.perf_counter()
        out = runner.infer_coupled(a, b)
        done = time.perf_counter()
        lat.append(done - t)
        if j < keep_n:
            kept.append((j, out))
        else:
            r = int(rng.integers(0, j + 1))
            if r < keep_n:
                kept[r] = (j, out)
        j += 1
        if done >= deadline:
            break
    peak, trace = 0, None
    if ctx.device.type == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated(ctx.device)
        if ctx.trace:
            from portbench.trace import Profiled

            with Profiled(ctx.device) as prof:
                for i in range(int(ctx.param("trace_calls"))):
                    runner.infer_coupled(*pair(j + i))
            trace = prof.trace
    lat_ms = 1e3 * np.asarray(lat)
    e2e = {"pair_p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": t0 - ctx.t_start}
    numbers, readings = check(ctx, cfg, w, frames_u8, kept)
    del runner
    free(ctx.device)
    layer = {"latencies_ms": lat_ms, "cfg": cfg, "trace_calls": int(ctx.param("trace_calls")),
             "setup": marks}
    failed = sum(1 for _, out in kept if not all(np.isfinite(o).all() for o in out))
    return Outcome(e2e, len(lat), failed, numbers, peak, readings, trace, layer)


def check(ctx: Ctx, cfg, w, frames_u8, kept) -> tuple:
    """The kept calls' two depth maps and pose against the reference's."""
    p = len(frames_u8)
    idx = np.asarray([j for j, _ in kept])
    prev, cur = frames_u8[idx % p], frames_u8[(idx + 1) % p]
    ref_a, ref_b, ref6 = serve.reference_pairs(w, cfg, prev, cur, ctx.device, False)
    prog_a = 1.0 / np.concatenate([o[0] for _, o in kept]).astype(np.float64)
    prog_b = 1.0 / np.concatenate([o[1] for _, o in kept]).astype(np.float64)
    prog6 = np.concatenate([np.concatenate([o[2], o[3]], axis=1) for _, o in kept])
    ref_sd = np.concatenate([ref_a, ref_b])
    numbers = {"depth_gap": serve.depth_gap(np.concatenate([prog_a, prog_b]), ref_sd),
               "pose_gap": serve.pose_gap(prog6.astype(np.float64), ref6),
               **serve.pose_parts(prog6.astype(np.float64), ref6)}
    readings = {}
    if "control" in ctx.readings:
        low = serve.control(w, cfg, prev, cur, ctx.device, False)
        readings["control"] = {
            "depth_gap": serve.depth_gap(np.concatenate([low["sd_a"], low["sd_b"]]), ref_sd),
            "pose_gap": serve.pose_gap(low["pose"], ref6), **serve.pose_parts(low["pose"], ref6)}
    return numbers, readings
