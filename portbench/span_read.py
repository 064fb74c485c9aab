"""What the per-layer readers of the program's own spans share.

The program keeps its spans in an in-memory ring in this process
(``colvo_torch.runtime.spans``), stamped through the whole run: set-up,
the timed window (where no profiler runs) and the traced run after it
(whose spans are ``profiled``). A reader takes the spans of one kind of
request (``requests``), leaves out those in which a program was captured,
and returns a median over the rest. A program without the recorder gives
None here, and so does every reader.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def spans() -> Optional[list]:
    """The spans the program's recorder holds, by start; None without one."""
    try:
        from colvo_torch.runtime import spans as recorder
    except ImportError:
        return None
    return recorder.snapshot().spans


def requests(name: str, profiled: bool = False) -> Optional[List[Tuple[object, Dict[str, list]]]]:
    """The spans ``name`` whose ``profiled`` flag is ``profiled``, but those
    holding a ``graph.capture``, each with its children by name."""
    every = spans()
    if every is None:
        return None
    kids: Dict[Optional[int], list] = defaultdict(list)
    for s in every:
        kids[s.parent].append(s)
    out = []
    for s in every:
        if s.name != name or s.profiled != profiled:
            continue
        by: Dict[str, list] = defaultdict(list)
        for c in kids[s.id]:
            by[c.name].append(c)
        if "graph.capture" not in by:
            out.append((s, by))
    return out


def median(values) -> Optional[float]:
    values = list(values)
    return float(np.median(values)) if values else None


def ms(children: list) -> float:
    """The summed ms of spans."""
    return sum(s.ms for s in children)


def trace_clock(trace, every: list, launch: str = "cudaGraphLaunch"
                ) -> Optional[Tuple[float, float, float]]:
    """The profiled spans put on the trace's clock: each profiled
    ``graph.replay`` matched, in order, to the trace's host events whose
    name starts with ``launch`` (the graph's launch inside it; the same
    count, or None). Returns (offset, median, largest residual), µs: a span
    at ``perf_counter_ns`` t lies at t / 1e3 + offset on the trace; the
    residuals are each launch's midpoint less its replay's so placed."""
    replays = [s for s in every if s.profiled and s.name == "graph.replay"]
    launches = sorted((e for e in trace.host if e["name"].startswith(launch)),
                      key=lambda e: e["ts"])
    if not replays or len(replays) != len(launches):
        return None
    d = np.array([(e["ts"] + e["dur"] / 2) - (s.start_ns + s.end_ns) / 2e3
                  for s, e in zip(replays, launches)])
    offset = float(np.median(d))
    res = np.abs(d - offset)
    return offset, float(np.median(res)), float(res.max())


def idle_gaps(trace) -> np.ndarray:
    """(n, 2) µs: the gaps between the trace's device intervals."""
    iv = np.asarray(trace.intervals, dtype=np.float64).reshape(-1, 2)
    return np.stack([iv[:-1, 1], iv[1:, 0]], axis=1) if len(iv) > 1 else np.zeros((0, 2))


def overlap_us(gaps: np.ndarray, a: float, b: float) -> float:
    """The µs of ``gaps`` inside [a, b]."""
    return float(np.clip(np.minimum(gaps[:, 1], b) - np.maximum(gaps[:, 0], a), 0, None).sum())
