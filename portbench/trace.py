"""A ``torch.profiler`` window and what the per-layer readers take from it.

``Profiled`` traces the CPU and the card between two synchronisations and
parses the Chrome trace it exports (into ``TMPDIR``, deleted at once):
kernels, copies and memsets on the device, and the host's runtime calls
and operators. ``busy_s`` is the union of the device intervals over the
window (overlapping kernels count once); ``window_s`` the window's length
on the host clock. The bucket table (``buckets.json``) maps kernel names
to the program's layers by keyword, first match winning.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

BUCKETS = json.loads((Path(__file__).parent / "buckets.json").read_text())["buckets"]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")


def bucket_of(name: str) -> str:
    low = name.lower()
    for bucket, keys in BUCKETS:
        if any(k in low for k in keys):
            return bucket
    return "other"


class Trace:
    """The parsed events of one traced window."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.intervals = self._merge(sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device))
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6

    @staticmethod
    def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def kernel_s(self, predicate) -> Tuple[float, int]:
        """(summed seconds, launches) of the kernels whose name satisfies ``predicate``."""
        hits = [e for e in self.kernels if predicate(e["name"])]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def bucket_s(self, bucket: str) -> float:
        return self.kernel_s(lambda n: bucket_of(n) == bucket)[0]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (``bucket: name``) and
        the idle gaps summed by what the host was doing in them."""
        ops: Counter = Counter()
        for e in self.device:
            ops[f"{bucket_of(e['name'])}: {e['name'][:96]}"] += e["dur"] / 1e6
        gaps: Counter = Counter()
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host)
        active: list = []  # heap of (end, start, name) of host events begun
        i = 0
        for (_, a), (b, _) in zip(self.intervals, self.intervals[1:]):
            while i < len(spans) and spans[i][0] < b:
                heapq.heappush(active, (spans[i][1], spans[i][0], spans[i][2]))
                i += 1
            while active and active[0][0] <= a:
                heapq.heappop(active)
            best, label = 0.0, "no host event"
            for t, s, name in active:
                over = min(t, b) - max(s, a)
                if over > best:
                    best, label = over, name[:96]
            gaps[label] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


class Profiled:
    """``with Profiled(device) as p: ...``; then ``p.trace``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.unlink(path)
        self.trace = Trace(events, window)
        return False
