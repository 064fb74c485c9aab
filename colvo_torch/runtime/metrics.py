"""Metrics and logging (port of ``colvo/runtime/metrics.py``).

``MetricsWriter`` writes a JSONL mirror (``metrics.jsonl``: ``step``,
``time``, then the scalars), stdout lines, PNG panels through a stdlib PNG
writer, and TensorBoard event files when ``torch.utils.tensorboard``
imports.

``AsyncMetricsLogger`` keeps the device→host fetch of a step's scalars off
the training loop: ``log`` stacks the scalars on the device and queues one
``non_blocking`` copy into pinned host memory behind a CUDA event
(:class:`DeviceScalars`), and a daemon thread waits on that event, never on
the whole stream. A ``.item()`` in the thread would copy on the default
stream and so wait for every step queued since, and the rate stamps and
the NaN guard would measure the queue, not the step. The guard therefore
fires a few steps late: the thread counts consecutive non-finite losses,
and the loop polls the count.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import time
import zlib
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch


class DeviceScalars:
    """A step's scalar tensors on their way to the host.

    On a CUDA device the scalars are stacked as float32, copied
    ``non_blocking`` into a pinned buffer on the current stream, and an
    event is recorded after the copy; :meth:`values` waits on that event
    only. On the CPU the stack is the value.
    """

    def __init__(self, scalars: Mapping[str, torch.Tensor]):
        self.keys: List[str] = list(scalars)
        stacked = torch.stack([torch.as_tensor(v).detach().reshape(()).float()
                               for v in scalars.values()])
        self._event: Optional[torch.cuda.Event] = None
        if stacked.is_cuda:
            self._host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            self._host.copy_(stacked, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = stacked

    def values(self) -> Dict[str, float]:
        """Blocks until the copy has landed; then the scalars as floats."""
        if self._event is not None:
            self._event.synchronize()
        return dict(zip(self.keys, self._host.tolist()))


def _png_bytes(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an 8-bit RGB PNG (zlib + struct, no filter)."""
    h, w, _ = rgb8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb8.reshape(h, 3 * w)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


class MetricsWriter:
    def __init__(self, log_dir: str, also_stdout: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.also_stdout = also_stdout
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:  # TensorBoard is optional, as in the reference
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir)
        self._t0 = time.time()

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {k: float(np.asarray(v)) for k, v in scalars.items()}
        rec = {"step": int(step), "time": time.time() - self._t0, **clean}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        if self.also_stdout:
            parts = " ".join(f"{k}={v:.5g}" for k, v in clean.items())
            print(f"[step {step}] {parts}", flush=True)

    def log_image(self, step: int, tag: str, img: np.ndarray) -> None:
        """img: (H, W, 3) float [0,1]. Saved as PNG panel + TB image."""
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step:08d}.png")
        with open(path, "wb") as f:
            f.write(_png_bytes((np.clip(img, 0, 1) * 255).astype(np.uint8)))
        if self._tb is not None:
            self._tb.add_image(tag, np.transpose(img, (2, 0, 1)), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class AsyncMetricsLogger:
    """Non-blocking front end over ``MetricsWriter`` (see module docstring).

    ``log`` queues a step's metrics (device tensors go through
    :class:`DeviceScalars`) and returns at once; a daemon thread fetches
    and writes them. ``bad_steps`` counts consecutive non-finite total
    losses seen by the thread, and the training loop polls it for the abort
    guard. An error in the thread is kept in ``error`` (the loop raises it)
    and raised again by ``close``.
    """

    def __init__(
        self,
        writer: MetricsWriter,
        loss_key: str = "loss/total",
        max_pending: int = 4,
        fps_scale: float = 0.0,
    ):
        self.writer = writer
        self.loss_key = loss_key
        self.bad_steps = 0
        self.dropped = 0
        self.error: Optional[BaseException] = None
        self.fps_scale = fps_scale  # batch size; 0 disables the fps column
        self._last_done: Optional[tuple] = None  # (step, fetch-complete time)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def log(self, step: int, metrics: Union[Mapping, DeviceScalars]) -> None:
        """Queue without blocking; drop the new item when the writer lags
        (the fetch sets the logging rate, not the training rate)."""
        if not isinstance(metrics, DeviceScalars) and any(
                isinstance(v, torch.Tensor) and v.is_cuda for v in metrics.values()):
            metrics = DeviceScalars(metrics)
        try:
            self._q.put_nowait((step, time.time(), metrics))
        except queue.Full:
            self.dropped += 1

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.error is None:
                try:
                    self._process(item)
                except Exception as e:  # kept for the loop, which raises it
                    self.error = e

    def _process(self, item) -> None:
        step, enq_t, metrics = item
        if isinstance(metrics, DeviceScalars):
            vals = metrics.values()
        else:
            vals = {k: float(np.asarray(v)) for k, v in metrics.items()}
        loss = vals.get(self.loss_key)
        if loss is not None and not np.isfinite(loss):
            self.bad_steps += 1
        else:
            self.bad_steps = 0
        # Throughput without syncing the training loop: the fetch above
        # waited for this step's scalars, so consecutive fetch-completion
        # times bound the step rate, but only when this thread was waiting
        # for the item. An item queued before the previous fetch completed
        # (a backlog) measures the queue's drain, not training: no stamp.
        # The unambiguous rate is the loop's end-of-run wall_steps_per_sec.
        now = time.time()
        if (
            self._last_done is not None
            and step > self._last_done[0]
            and enq_t >= self._last_done[1]
        ):
            sps = (step - self._last_done[0]) / max(now - self._last_done[1], 1e-9)
            vals["steps_per_sec"] = sps
            if self.fps_scale:
                vals["fps"] = sps * self.fps_scale
        self._last_done = (step, now)
        self.writer.log_scalars(step, vals)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self.writer.close()
        if self.error is not None:
            raise RuntimeError("the metrics thread failed") from self.error
