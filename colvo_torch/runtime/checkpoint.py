"""Checkpointing (port of ``colvo/runtime/checkpoint.py``, without Orbax).

One directory a step, ``<dir>/<step>/state.pt`` (``torch.save`` of the
model and optimizer ``state_dict``s, ``step`` and ``steps_per_epoch``),
plus ``loader.bin`` when the input pipeline's state is given. A step is
written into ``<step>.tmp`` and renamed into place, so a killed save never
leaves a half-written step that :meth:`CheckpointManager.latest_step`
would pick. Keep-N and the save interval follow Orbax's
``CheckpointManager`` as the reference configures it.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from colvo_torch.runtime.train_step import TrainState

_STATE, _LOADER = "state.pt", "loader.bin"


def _to_host(obj: Any, pinned: bool) -> Any:
    """A copy of a (nested) state dict with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        if pinned and obj.is_cuda:
            host = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
            return host.copy_(obj.detach(), non_blocking=True)
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, pinned) for v in obj)
    return obj


class Snapshot:
    """The train state at one point of the stream of work.

    Taken on the current stream: on a CUDA device every tensor is copied
    ``non_blocking`` into pinned host memory and an event is recorded, so
    an in-place optimizer step queued later cannot change what is saved,
    and nothing waits until :meth:`result`. On the CPU the copies are
    made at once.
    """

    def __init__(self, state: TrainState):
        cuda = any(p.is_cuda for p in state.model.parameters())
        self._payload = {
            "model": _to_host(state.model.state_dict(), cuda),
            "optimizer": _to_host(state.optimizer.state_dict(), cuda),
            "step": int(state.step),
            "steps_per_epoch": int(state.steps_per_epoch),
        }
        self._event: Optional[torch.cuda.Event] = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def result(self) -> Dict[str, Any]:
        if self._event is not None:
            self._event.synchronize()
        return self._payload


class CheckpointManager:
    """Saves, lists, evicts and restores train states under ``directory``.

    ``save`` takes the snapshot on the caller's stream and hands the write
    to one worker thread, which also runs ``reset``, so a reset stays
    ordered after the saves queued before it. ``wait`` blocks until the
    queued work is done and raises its first error.
    """

    def __init__(self, directory: str, keep: int = 3, save_interval_steps: int = 1):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        for name in os.listdir(self._dir):  # left behind by a killed save
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self._dir, name))
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._steps: List[int] = self._on_disk()  # saved or queued, ascending
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def _on_disk(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def should_save(self, step: int) -> bool:
        """Orbax's rule: never at or before the latest step; else on every
        ``save_interval_steps``-th step, and always when none is saved."""
        if self._steps and self._steps[-1] >= step:
            return False
        return not self._steps or step % self.save_interval_steps == 0

    def _submit(self, fn, *args) -> None:
        self._pending = [f for f in self._pending if not f.done() or f.exception()]
        self._pending.append(self._pool.submit(fn, *args))

    def save(self, step: int, state: TrainState,
             loader_state: Optional[bytes] = None) -> bool:
        """Snapshot ``state`` now and queue its write at ``step``, with the
        input pipeline's state when given; returns whether a save was
        queued (see :meth:`should_save`)."""
        if not self.should_save(step):
            return False
        snap = Snapshot(state)
        self._steps.append(step)
        evicted, self._steps = self._steps[:-self.keep], self._steps[-self.keep:]
        self._submit(self._write, step, snap, loader_state, evicted)
        return True

    def _write(self, step: int, snap: Snapshot, loader_state: Optional[bytes],
               evicted: List[int]) -> None:
        final = self._step_dir(step)
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} exists in {self._dir}")
        tmp = final + ".tmp"
        os.makedirs(tmp)
        torch.save(snap.result(), os.path.join(tmp, _STATE))
        if loader_state is not None:
            with open(os.path.join(tmp, _LOADER), "wb") as f:
                f.write(loader_state)
        os.replace(tmp, final)
        for s in evicted:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def load(self, step: Optional[int] = None):
        """The payload saved at ``step`` (default the latest): (dict with
        ``model``, ``optimizer``, ``step``, ``steps_per_epoch``; the step;
        the loader state or None)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        path = os.path.join(self._step_dir(step), _STATE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self._dir}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        loader_path = os.path.join(self._step_dir(step), _LOADER)
        loader_state = None
        if os.path.exists(loader_path):
            with open(loader_path, "rb") as f:
                loader_state = f.read()
        return payload, step, loader_state

    def restore(self, state_like: TrainState, step: Optional[int] = None,
                with_loader_state: bool = False):
        """Restore the latest (or given) step into ``state_like`` in place.
        Returns (state, step), or (state, step, loader_state_bytes_or_None)
        when ``with_loader_state``."""
        payload, step, loader_state = self.load(step)
        state_like.model.load_state_dict(payload["model"])
        opt = state_like.optimizer
        live = [(g["lr"], g["capturable"]) for g in opt.param_groups]
        opt.load_state_dict(payload["optimizer"])
        # The learning rate's holder (a device tensor that each step
        # overwrites, on CUDA) and capturability are the live optimizer's,
        # whatever device saved the checkpoint; Adam's step counts follow.
        for group, (lr, capturable) in zip(opt.param_groups, live):
            group["lr"], group["capturable"] = lr, capturable
            for p in group["params"]:
                if "step" in opt.state.get(p, {}):
                    opt.state[p]["step"] = opt.state[p]["step"].to(
                        p.device if capturable else "cpu")
        state_like.step = payload["step"]
        state_like.steps_per_epoch = payload["steps_per_epoch"]
        if with_loader_state:
            return state_like, step, loader_state
        return state_like, step

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def reset(self) -> None:
        """Delete every saved step, after the saves queued before. Basin
        detect-and-restart discards a failed attempt's checkpoints so that
        the retry saves the same step numbers again."""
        self._steps = []
        self._submit(self._delete_all)

    def _delete_all(self) -> None:
        for s in self._on_disk():
            shutil.rmtree(self._step_dir(s))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
