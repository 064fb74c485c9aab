"""Median host-clock ms of the window's infer_coupled calls."""

import numpy as np


def read(run):
    lat = run.layer.get("latencies_ms")
    return float(np.median(lat)) if lat is not None and len(lat) else None
