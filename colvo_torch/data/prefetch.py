"""Device prefetch (port of ``colvo/data/prefetch.py``).

A producer thread builds each host batch (the numpy loader's decode and
augmentation) ahead of the step. On a CUDA device it stages every array in
a pinned host buffer and copies it ``non_blocking`` on a side stream, then
records an event; the consumer makes its stream wait on that event before
it uses the batch, so the copy overlaps the running step.

The producer's time is spans (``runtime.spans``; attr ``batch``, the batch
index): ``prefetch.build`` (the host batch), ``prefetch.stage`` (the pinned
copy and the queued upload; on the CPU the tensors) and
``prefetch.put_wait`` (the queue full).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from colvo_torch import resolve_device

_END = object()


class _Failed:
    """The producer's exception, on its way to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class _CudaStager:
    """Pinned staging buffers for the batches' host→device copies, on a
    copy stream, ``slots`` sets reused round-robin. A set is written again
    only after the copy that last read it has completed (its event)."""

    def __init__(self, device: torch.device, slots: int):
        self.device, self.slots = device, slots
        self.copy = torch.cuda.Stream(device)
        self.pinned: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self.done = [torch.cuda.Event() for _ in range(slots)]
        self.k = 0

    def upload(self, batch: Mapping[str, Any]):
        s = self.k % self.slots
        self.k += 1
        self.done[s].synchronize()
        out: Dict[str, torch.Tensor] = {}
        seen: Dict[int, torch.Tensor] = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.copy):
            for name, value in batch.items():
                if id(value) in seen:  # frames_clean is frames without augmentation
                    out[name] = seen[id(value)]
                    continue
                host = np.asarray(value, dtype=np.float32)
                buf = self.pinned[s].get(name)
                if buf is None or tuple(buf.shape) != host.shape:
                    buf = self.pinned[s][name] = torch.empty(host.shape, pin_memory=True)
                np.copyto(buf.numpy(), host)
                out[name] = seen[id(value)] = buf.to(self.device, non_blocking=True)
            self.done[s].record(self.copy)
        return out, self.done[s]


def prefetch_to_device(
    iterator: Iterator[Mapping[str, Any]],
    size: int = 2,
    device: str | torch.device = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator (dicts of arrays) with a ``size``-deep
    buffer of float32 batches on ``device``, built by a producer thread.

    Order is kept, and the stream ends when ``iterator`` does. An exception
    in the producer is raised in the consumer. Closing the generator stops
    the producer.
    """
    from colvo_torch.runtime.spans import span  # the runtime package imports this one

    device = resolve_device(device)
    # Slots: ``size`` queued, one being built, one in the consumer's hands.
    stager = _CudaStager(device, size + 2) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            it = iter(iterator)
            for i in itertools.count():
                with span("prefetch.build", batch=i):
                    batch = next(it, _END)
                if batch is _END:
                    break
                with span("prefetch.stage", batch=i):
                    if stager is not None:
                        item = stager.upload(batch)
                    else:
                        item = ({k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
                                 for k, v in batch.items()}, None)
                with span("prefetch.put_wait", batch=i):
                    if not put(item):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            put(_Failed(e))
            return
        put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise RuntimeError("the batch producer failed") from item.error
            batch, ready = item
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                # allocated on the copy stream, used on the compute stream
                for t in batch.values():
                    t.record_stream(compute)
            yield batch
    finally:
        stop.set()
        thread.join()
