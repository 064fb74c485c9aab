"""Depth evaluation (numpy copy of ``colvo/evaluation/depth.py``).

The standard metric suite (Abs Rel, Sq Rel, RMSE, RMSE-log,
δ<1.25/1.25²/1.25³) with per-image median scaling and a depth cap, and the
signed error maps. Metrics reduce in host numpy; only the model forward
runs on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


DEPTH_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def compute_depth_errors(
    gt: np.ndarray,
    pred: np.ndarray,
    min_depth: float = 1e-3,
    max_depth: float = 1.0,
    median_scaling: bool = True,
) -> Dict[str, float]:
    """Standard 7-metric depth evaluation over a batch of maps.

    Args:
        gt, pred: (N, H, W) ground-truth and predicted depth.
        min_depth/max_depth: validity range + cap (colon-scale default).
        median_scaling: per-image ``pred *= median(gt)/median(pred)``.
    """
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    per_image = {k: [] for k in DEPTH_METRIC_NAMES}
    for g, p in zip(gt, pred):
        mask = (g > min_depth) & (g < max_depth) & np.isfinite(g)
        g_v = g[mask]
        p_v = p[mask]
        if median_scaling:
            p_v = p_v * (np.median(g_v) / max(np.median(p_v), 1e-12))
        p_v = np.clip(p_v, min_depth, max_depth)

        thresh = np.maximum(g_v / p_v, p_v / g_v)
        per_image["a1"].append(float((thresh < 1.25).mean()))
        per_image["a2"].append(float((thresh < 1.25**2).mean()))
        per_image["a3"].append(float((thresh < 1.25**3).mean()))
        per_image["abs_rel"].append(float(np.mean(np.abs(g_v - p_v) / g_v)))
        per_image["sq_rel"].append(float(np.mean((g_v - p_v) ** 2 / g_v)))
        per_image["rmse"].append(float(np.sqrt(np.mean((g_v - p_v) ** 2))))
        per_image["rmse_log"].append(
            float(np.sqrt(np.mean((np.log(g_v) - np.log(p_v)) ** 2)))
        )
    return {k: float(np.mean(v)) for k, v in per_image.items()}


def signed_error_map(
    gt: np.ndarray,
    pred: np.ndarray,
    median_scaling: bool = True,
    max_depth: float = 1.0,
) -> np.ndarray:
    """Per-pixel signed error (pred − gt) after median scaling — the
    positive/negative maps in ``imgs/qualitativeresults.png``."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    mask = (gt > 1e-6) & np.isfinite(gt)
    if median_scaling:
        scale = np.median(gt[mask]) / max(np.median(pred[mask]), 1e-12)
        pred = pred * scale
    err = np.where(mask, np.clip(pred, 0, max_depth) - gt, 0.0)
    return err.astype(np.float32)


def evaluate_depth(
    runner,
    frames: np.ndarray,
    gt_depths: np.ndarray,
    cfg=None,
    batch_size: int = 8,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Run DepthNet over frames and score against dense GT.

    Returns (metric dict, predicted depths (N, H, W)).
    """
    preds = []
    n = len(frames)
    # one batch shape for every call: pad the tail batch
    for start in range(0, n, batch_size):
        chunk = frames[start : start + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        depth, _ = runner.infer_depth(chunk)
        preds.append(depth[: len(chunk) - pad if pad else batch_size])
    pred = np.concatenate(preds)[:n]
    max_d = cfg.eval.depth_cap if cfg is not None else 1.0
    med = cfg.eval.median_scaling if cfg is not None else True
    metrics = compute_depth_errors(gt_depths, pred, max_depth=max_d, median_scaling=med)
    return metrics, pred
