"""Streaming VO traffic: one ``colvo_torch.vo.driver.run_vo`` call over a
recorded procedure, as fast as the stream takes frames (closed loop).

Parameters: ``pool_frames`` consecutive rendered frames (uint8 RGB on the
host) cycled as the video; ``run_vo``'s settings in ``vo`` (chunk size,
wire dtype, symmetric pose, keyframe interval); ``warm_frames`` for the
set-up call that captures the init and chunk programs; ``trace_frames``
for the traced call after the window; ``check_frames`` keyframes sampled
from the seed for the check. The window is one call: its generator stops
yielding at the first chunk boundary past ``--seconds``, and the window
closes when ``run_vo`` returns its trajectory.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Ctx, Outcome, free, sync
from portbench.kinds import serve


def _stream(frames: np.ndarray, chunk: int, deadline: float, counter: list):
    """The cycled pool up to the first chunk boundary past ``deadline`` (one
    chunk at the least); the count of frames yielded goes to ``counter``."""
    n = 0
    while not (n > chunk and (n - 1) % chunk == 0 and time.perf_counter() >= deadline):
        yield frames[n % len(frames)]
        n += 1
    counter.append(n)


def _log_rotation(r: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    scale = 0.5 + theta**2 / 12.0 if theta < 1e-4 else theta / (2.0 * np.sin(theta))
    return w * scale


def run(ctx: Ctx) -> Outcome:
    from colvo_torch.vo.driver import run_vo

    cfg = ctx.colvo_config()
    marks = [("start", time.perf_counter())]
    runner, w = serve.runner(ctx, cfg)
    marks.append(("weights and runner", time.perf_counter()))
    frames = serve.pool(ctx, cfg)
    marks.append(("render", time.perf_counter()))
    kw = dict(ctx.param("vo"))
    chunk = int(kw["chunk_size"])
    run_vo(runner, iter(frames[:int(ctx.param("warm_frames"))]), **kw)
    sync(ctx.device)
    marks.append(("warm-up call (capture)", time.perf_counter()))
    count: list = []
    sync(ctx.device)
    t0 = time.perf_counter()
    result = run_vo(runner, _stream(frames, chunk, t0 + ctx.seconds, count), **kw)
    sync(ctx.device)
    t1 = time.perf_counter()
    n = count[0]
    peak = 0
    trace = None
    if ctx.device.type == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated(ctx.device)
        if ctx.trace:
            from portbench.trace import Profiled

            traced = int(ctx.param("trace_frames"))
            with Profiled(ctx.device) as prof:
                run_vo(runner, (frames[i % len(frames)] for i in range(traced)), **kw)
            trace = prof.trace
    e2e = {"vo_frames_per_s": n / (t1 - t0), "setup_s": t0 - ctx.t_start}
    numbers, readings = check(ctx, cfg, w, frames, result, kw)
    del runner
    free(ctx.device)
    layer = {"frames_per_s": e2e["vo_frames_per_s"], "trace_frames": int(ctx.param("trace_frames")),
             "cfg": cfg, "symmetric": kw.get("symmetric_pose", False),
             "setup": marks}
    failed = n - len(result.poses)
    return Outcome(e2e, n, max(failed, 0), numbers, peak, readings, trace, layer)


def check(ctx: Ctx, cfg, w, frames, result, kw) -> tuple:
    """Sampled keyframes' depth and the relative pose that reached each,
    read back from the chained trajectory, against the reference."""
    rng = np.random.default_rng(ctx.seed)
    kf = np.asarray(result.keyframe_ids[1:])
    pick = np.unique(np.concatenate([rng.choice(kf, min(len(kf), int(ctx.param("check_frames")))
                                                - 1, replace=False), kf[-1:]]))
    slot = {i: j for j, i in enumerate(result.keyframe_ids)}
    p = len(frames)
    prev, cur = frames[(pick - 1) % p], frames[pick % p]
    sym = bool(kw.get("symmetric_pose", False))
    _, ref_sd, ref6 = serve.reference_pairs(w, cfg, prev, cur, ctx.device, sym)
    prog_sd = 1.0 / np.stack([result.depths[slot[i]] for i in pick]).astype(np.float64)
    prog6 = []
    for i in pick:
        rel = np.linalg.inv(result.poses[i]) @ result.poses[i - 1]
        prog6.append(np.concatenate([_log_rotation(rel[:3, :3]), rel[:3, 3]]))
    prog6 = np.stack(prog6)
    numbers = {"depth_gap": serve.depth_gap(prog_sd, ref_sd),
               "pose_gap": serve.pose_gap(prog6, ref6), **serve.pose_parts(prog6, ref6)}
    readings = {}
    if "control" in ctx.readings:
        wire = serve.uint8_wire if kw.get("depth_dtype") == "uint8" else None
        low = serve.control(w, cfg, prev, cur, ctx.device, sym, wire)
        readings["control"] = {"depth_gap": serve.depth_gap(low["sd_b"], ref_sd),
                               "pose_gap": serve.pose_gap(low["pose"], ref6),
                               **serve.pose_parts(low["pose"], ref6)}
    return numbers, readings
