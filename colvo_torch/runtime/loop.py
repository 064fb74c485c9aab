"""Training loop (port of ``colvo/runtime/loop.py``).

Epochs over the snippet dataset with device prefetch (from the numpy
loader or the checkpointable ``data.loader="grain"``), or from a corpus
held on the device (``data.loader="device"``); periodic checkpoints (with
the grain loader's state), async metrics, the NaN guards, basin
detect-and-restart, the profiler window and the eval hook. Under a
``torch.distributed`` process group the step is data parallel over its
ranks (``runtime.mesh``): each rank trains on its rows of the global
batch, and rank 0 alone writes checkpoints, metrics, traces and the eval
hook's output. ``train.deterministic`` runs it bitwise reproducibly
(``deterministic_mode``). Each step is one replay of the captured step
(``make_step_fn``); the device loader's batch and the eval hook's forward
are captured programs of their own. Only the step under a mesh of more
than one rank and under ``train.debug_nans`` runs eagerly. No step of the
loop waits for the device, except the bounded dispatch-ahead drain, the
one fetch of the restart check, the eval hook and the end of the run.

Each step's host time is spans (``runtime.spans``; attr ``step``, the
step's index, which a restart sets back to 0): ``loop.batch`` (the next
batch: on the device loader its program's replay, on the host loaders the
wait for the producer), ``loop.step`` (the step function), ``loop.log``
(the logged scalars' fetch queued), ``loop.drain`` (the dispatch-ahead
drain), ``loop.ckpt``, ``loop.eval`` and ``loop.restart_fetch``.
``wall_steps_per_sec`` and ``wall_fps``, logged at the end, are the steps
after the first over the time from the first step's end (the capture's;
on the card the host waits for its replay there, once) to the end.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator
from colvo_torch.data.device_store import DeviceSnippetStore
from colvo_torch.data.grain_loader import grain_batch_iterator
from colvo_torch.data.prefetch import prefetch_to_device
from colvo_torch.runtime.checkpoint import CheckpointManager
from colvo_torch.runtime.mesh import cross_process_barrier, make_mesh, replicate_tree, shard_batch
from colvo_torch.runtime.metrics import AsyncMetricsLogger, DeviceScalars, MetricsWriter
from colvo_torch.runtime.spans import span
from colvo_torch.runtime.train_step import init_state, make_train_step, train_step

# Host→device prefetch depth of the host-side loaders. The grain
# iterator's state history is sized from it.
_PREFETCH = 2


def _check_supported(cfg: ColvoConfig) -> None:
    if cfg.data.loader not in ("numpy", "grain", "device"):
        raise ValueError(f"unknown data.loader {cfg.data.loader!r}")


class _SilentWriter:
    """The metrics writer of a rank other than 0: it writes nothing (the
    logger still counts non-finite losses, which are global)."""

    log_dir = None

    def log_scalars(self, step, scalars) -> None:
        pass

    def log_image(self, step, tag, img) -> None:
        pass

    def close(self) -> None:
        pass


def train(
    cfg: ColvoConfig,
    dataset: SnippetDataset,
    log_dir: str = "runs/train",
    max_steps: Optional[int] = None,
    eval_hook: Optional[Callable] = None,
    eval_hook_factory: Optional[Callable] = None,
    resume: bool = False,
    device: str | torch.device = "cuda",
):
    """Full training entry. Returns (model, final state)."""
    _check_supported(cfg)
    device = resolve_device(device)
    # Sanitizer modes: the first op that makes a NaN raises, with the
    # forward op's trace; and/or bitwise-reproducible runs.
    with torch.autograd.set_detect_anomaly(bool(cfg.train.debug_nans)), \
            deterministic_mode(bool(cfg.train.deterministic)):
        return _train(cfg, dataset, log_dir, max_steps, eval_hook, eval_hook_factory,
                      resume, device)


@contextlib.contextmanager
def deterministic_mode(on: bool):
    """``train.deterministic`` in PyTorch's terms, as the reference pins
    matmul precision to "highest" (``colvo/runtime/loop.py:42-43``): TF32
    off for matmuls and cuDNN, ``torch.use_deterministic_algorithms(True)``
    (an op without a deterministic kernel raises; kernel T takes its
    fixed-point variant), cuDNN deterministic without autotuning, and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``. cuBLAS reads that variable when
    its handle is made, so only a process that has run no matmul on the
    card before is bitwise reproducible (``cli train`` is). Every flag is
    put back on exit."""
    if not on:
        yield
        return
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    if saved[-1] is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved[:4]
        torch.use_deterministic_algorithms(saved[4], warn_only=saved[5])
        if saved[-1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def make_step_fn(state, cfg: ColvoConfig) -> Callable:
    """The loop's step function ``(state, batch) → metrics`` for ``state``:
    the captured step of ``make_train_step`` (a CUDA graph on the card),
    except in two cases, each of which runs ``train_step`` eagerly (the
    only programs of the reference that run eagerly on the card):

    * a mesh of more than one rank: the loss's ~34 scalar all-reduces go
      through gloo or NCCL a step, and gloo cannot be captured;
    * ``train.debug_nans``: anomaly mode checks every backward op's output
      on the host.
    """
    def eager(state, batch):
        return train_step(state, batch, cfg)

    if state.mesh is not None and state.mesh.size > 1:
        return eager
    if cfg.train.debug_nans:
        return eager
    return make_train_step(state, cfg)


def _train(cfg, dataset, log_dir, max_steps, eval_hook, eval_hook_factory, resume, device):
    steps_per_epoch = max(1, len(dataset) // cfg.data.batch_size)
    total_steps = (
        max_steps if max_steps is not None else steps_per_epoch * cfg.train.epochs
    )

    # Data parallel over the process group's ranks (one alone): the
    # weights are rank 0's, each rank steps on its rows of the global batch.
    mesh = make_mesh(cfg.mesh)
    if cfg.data.batch_size % mesh.size:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} does not split over "
                         f"{mesh.size} ranks")
    lead = mesh.rank == 0  # the rank that writes
    state = init_state(cfg, device=device, steps_per_epoch=steps_per_epoch)
    state.mesh = mesh
    replicate_tree(state.model, mesh)
    if not lead:
        eval_hook = None  # rank 0 alone evaluates and writes the panels
    elif eval_hook is None and eval_hook_factory is not None and cfg.train.eval_every_epochs > 0:
        eval_hook = eval_hook_factory(cfg, state.model)
    eval_every = max(1, steps_per_epoch * max(cfg.train.eval_every_epochs, 1))

    ckpt = CheckpointManager(
        cfg.train.ckpt_dir, keep=cfg.train.ckpt_keep,
        save_interval_steps=cfg.train.ckpt_every_steps,
    )
    start_step = 0
    restored_loader_state = None
    if resume:
        cross_process_barrier("resume")  # every rank reads what rank 0 wrote
        if ckpt.latest_step() is not None:
            state, start_step, restored_loader_state = ckpt.restore(
                state, with_loader_state=True)
            print(f"resumed from step {start_step}", flush=True)

    # The fetch of logged scalars runs on the logger's thread, behind a
    # CUDA event of its own (metrics.py).
    logger = AsyncMetricsLogger(MetricsWriter(log_dir) if lead else _SilentWriter(),
                                fps_scale=float(cfg.data.batch_size))

    profile_window = None
    if cfg.train.profile_steps:
        a, _, b = cfg.train.profile_steps.partition(":")
        profile_window = (int(a), int(b))
    prof = None

    if cfg.data.loader == "device":
        # The corpus on the device as uint8, uploaded once; a batch is
        # gathered and augmented there, so the host only dispatches.
        store = DeviceSnippetStore(dataset.sequences, dataset.intrinsics,
                                   cfg.data.frame_offsets, device=device)
        batches = store.batches(cfg.data, seed=cfg.train.seed)
    elif cfg.data.loader == "grain":
        # keep: the checkpointed step trails the last batch pulled by at
        # most the prefetch depth, plus a margin
        batches = grain_batch_iterator(dataset, cfg.data, seed=cfg.train.seed,
                                       keep=_PREFETCH + 14)
    else:
        batches = batch_iterator(dataset, cfg.data, seed=cfg.train.seed)
    grain = cfg.data.loader == "grain"
    if grain and restored_loader_state is not None:
        # Exact resume: the checkpoint holds the grain iterator's state at
        # the saved step, so the stream continues bit for bit.
        batches.set_state(restored_loader_state)
    else:
        # Skip already-consumed batches on resume (a position-only
        # approximation: it reproduces the stream only inside the first epoch).
        for _ in range(start_step % steps_per_epoch):
            next(batches)
    # Grain batches consumed before this run's first step; with the count of
    # steps taken since (``consumed``, which a restart does not reset) it
    # keys the state saved with a checkpoint.
    grain_base = batches.count if grain else 0
    consumed = 0
    # every rank draws the global batch and keeps its rows (on the device
    # loader, views of its program's static batch: the step reads them on
    # this stream before the next batch's replay overwrites them)
    rows = (shard_batch(b, mesh) for b in batches) if mesh.size > 1 else batches
    if cfg.data.loader == "device":
        stream = rows  # already on the device
    else:
        stream = prefetch_to_device(rows, size=_PREFETCH, device=device)

    # Made after the restore: the step's graph holds this state's tensors,
    # and its device counter starts from the restored step.
    step_fn = make_step_fn(state, cfg)
    step = start_step
    inflight: deque = deque()  # (step, DeviceScalars) awaiting retirement

    def drain_inflight(down_to: int = 0) -> None:
        """Retire queued loss fetches (each waits for its own event) down
        to ``down_to`` entries; raise on any non-finite value. Called with
        0 before the final checkpoint and at loop exit, so that a NaN in
        the last dispatch-ahead windows cannot escape the dispatch-side stop
        and checkpoint poisoned weights."""
        with span("loop.drain"):
            while len(inflight) > down_to:
                s_old, fetched = inflight.popleft()
                loss = fetched.values().get("loss/total")
                if loss is not None and not np.isfinite(loss):
                    raise RuntimeError(f"aborting: non-finite loss at step {s_old}")

    # Basin detect-and-restart: one blocking fetch of train.restart_metric
    # at train.restart_check_step; over the threshold, reinit with a
    # derived seed and reset the step clock. The data stream is not
    # restarted: replaying the same batches under a new init keeps the
    # attempts comparable.
    restarts_used = 0
    restart_checked = False

    # The rate's clock starts when the first step (which captures) returns.
    wall_t0 = wall_step0 = None
    try:
        while True:
            with span("loop.batch", step=step):
                batch = next(stream, None)
            if batch is None or step >= total_steps:
                break
            if lead and profile_window and step == profile_window[0]:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            i = step  # this step's index, the request id of its spans
            with span("loop.step", step=i):
                metrics = step_fn(state, batch)
            step += 1
            consumed += 1
            if wall_t0 is None:
                if device.type == "cuda":  # its replay is still queued
                    torch.cuda.synchronize(device)
                wall_t0, wall_step0 = time.perf_counter(), step

            if prof is not None and step == profile_window[1]:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_steps_{profile_window[0]}_{profile_window[1]}.json"))
                prof = None

            if logger.error is not None:
                raise RuntimeError("the metrics thread failed") from logger.error
            if logger.bad_steps >= cfg.train.max_bad_steps:
                raise RuntimeError(
                    f"aborting: {logger.bad_steps} consecutive non-finite losses"
                )
            if step % cfg.train.log_every == 0 or step == total_steps:
                with span("loop.log", step=i):
                    # One device→host copy serves the logger and the drain;
                    # steps_per_sec/fps are stamped by the logger thread.
                    fetched = DeviceScalars(metrics)
                    logger.log(step, fetched)
                    # Bounded dispatch-ahead: retire the loss from N windows
                    # back, so a crawling or diverged device cannot queue an
                    # unbounded run of steps, and a NaN stops the loop on the
                    # dispatch side.
                    inflight.append((step, fetched))
                    drain_inflight(max(int(cfg.train.dispatch_ahead_windows), 1))

            if (cfg.train.restart_threshold > 0 and not restart_checked
                    and restarts_used < cfg.train.restart_max
                    and step >= cfg.train.restart_check_step):
                restart_checked = True
                name = cfg.train.restart_metric
                if name not in metrics:
                    raise ValueError(
                        f"train.restart_metric {name!r} not in step metrics "
                        f"{sorted(metrics)}"
                    )
                with span("loop.restart_fetch", step=i):
                    val = float(metrics[name])  # one blocking fetch
                if val > cfg.train.restart_threshold:
                    restarts_used += 1
                    new_seed = cfg.train.seed + 1000 * restarts_used
                    logger.log(step, {
                        "restart/attempt": float(restarts_used),
                        "restart/metric_value": val,
                        "restart/new_seed": float(new_seed),
                    })
                    print(f"[restart {restarts_used}/{cfg.train.restart_max}] "
                          f"{name}={val:.4g} > {cfg.train.restart_threshold} "
                          f"at step {step}; reinit with seed {new_seed}",
                          flush=True)
                    inflight.clear()  # the discarded attempt's fetches
                    del step_fn, metrics  # the old graph holds the old model's tensors
                    state = init_state(cfg, seed=new_seed, device=device,
                                       steps_per_epoch=steps_per_epoch)
                    state.mesh = mesh
                    replicate_tree(state.model, mesh)
                    step_fn = make_step_fn(state, cfg)
                    if lead:
                        ckpt.reset()  # on the checkpoint worker, after earlier saves
                    step = 0
                    restart_checked = False
                    wall_t0 = None
                    continue

            if step % cfg.train.ckpt_every_steps == 0 or step == total_steps:
                with span("loop.ckpt", step=i):
                    if step == total_steps:
                        # Final checkpoint: retire every queued loss first, so
                        # a late NaN aborts before poisoned weights are saved.
                        drain_inflight(0)
                    # Snapshot on the compute stream, written by the manager's
                    # worker: the next step's in-place update cannot race it.
                    # The grain state is that after exactly this step's
                    # batches, though the prefetcher has pulled further.
                    if lead:
                        ckpt.save(step, state, loader_state=(
                            batches.state_at(grain_base + consumed) if grain else None))

            if eval_hook is not None and step % eval_every == 0:
                with span("loop.eval", step=i):
                    # Hook contract: (step, state, writer) → optional scalars,
                    # logged as eval/* rows beside the training rows; panels
                    # go straight to writer.log_image.
                    scalars = eval_hook(step, state, logger.writer)
                    if scalars:
                        logger.log(step, scalars)

        drain_inflight(0)  # early break / non-aligned final step
        ckpt.wait()
        # End of run: the one deliberate device sync. Wall time over the
        # steps after the first is the unambiguous rate.
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if wall_t0 is not None and step > wall_step0:
            wall = time.perf_counter() - wall_t0
            logger.log(step, {
                "wall_steps_per_sec": (step - wall_step0) / wall,
                "wall_fps": (step - wall_step0) * cfg.data.batch_size / wall,
            })
    finally:
        if prof is not None:
            prof.stop()
        stream.close()
        ckpt.close()
        logger.close()
    return state.model, state
