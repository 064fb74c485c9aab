"""The in-loss gauge ratio r = mean ||t|| / depth on trained runs (port of
``scripts/gauge_probe.py``).

``scale_decoupling`` measures s_traj / s_depth against ground truth; a fix
needs a quantity the training loss sees without it. This probes r on
trained runs, healthy and collapsed, so that the gauge prior's band
(``loss.gauge_lo``/``gauge_hi``) is set from measurement: healthy runs
should cluster within it, collapsed ones sit about 100× below.

For each run, on the first ``n_frames`` frames (12) of the held-out
sequence (seed 999; with the exposure gain for ``expjit_*`` cells): the
mean norm of the translation over the consecutive pairs, the median and
mean predicted depth, and r against each (the loss uses the mean). Under
``runs/ablate`` the runs are ``RUNS``; under any other root, every cell
with weights, its evaluation arm and architecture read from its name as
``ablate.run_cell`` names cells. One JSON line a run.

Run: ``python -m colvo_torch.scripts.gauge_probe [ablate_root] [n_frames]
[--device cuda|cpu]`` (the reference's ``COLVO_PLATFORM=cpu`` is
``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List

import numpy as np

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.pipelines import make_runner
from colvo_torch.scripts.scale_decoupling import held_out

RUNS = [
    # (run dir, evaluated on the jittered sequence, model overrides): collapsed and healthy
    ("expjit_dcdp1_lccG", True, []),
    ("expjit_dcdp1_lccG_s1234", True, []),   # collapsed (196x)
    ("expjit_dcdp1_lccG_s7", True, []),      # collapsed (110x)
    ("dcdp0_lcc0", False, ["--model.dcdp_fusion=false"]),
    ("dcdp0_lcc0_s1234", False, ["--model.dcdp_fusion=false"]),  # collapsed
    ("dcdp1_lcc1", False, []),
    ("dcdp1_lcc1_s7", False, []),
    ("expjit_dcdp1_lcc1", True, []),
]


def runs_under(root: str) -> list:
    """``RUNS`` under ``runs/ablate``; elsewhere (``runs/gauge2``,
    ``runs/levers``, ...) every cell with weights."""
    if os.path.normpath(root) == os.path.normpath("runs/ablate"):
        return RUNS
    runs = []
    for w in sorted(glob.glob(os.path.join(root, "*", "weights.npz"))):
        name = os.path.basename(os.path.dirname(w))
        runs.append((name, name.startswith("expjit_"),
                     ["--model.dcdp_fusion=false"] if "dcdp0" in name else []))
    return runs


def main(root: str = "runs/ablate", n_frames: int = 12, device: str = "cuda") -> List[dict]:
    """Probe every run; returns the JSON lines' records."""
    device = resolve_device(device)
    seqs = held_out(ColvoConfig(), n_frames)
    out = []
    for run, jit_arm, overrides in runs_under(root):
        weights = os.path.join(root, run, "weights.npz")
        if not os.path.exists(weights):
            rec = {"run": run, "skip": "missing"}
        else:
            cfg = ColvoConfig()  # the forward does not depend on the loss's knobs
            if overrides:
                cfg.apply_overrides(overrides)
            runner = make_runner(cfg, weights, device)
            frames = np.asarray(seqs[jit_arm].frames, np.float32)
            depth, _ = runner.infer_depth(frames)
            pose6 = runner.infer_pose(frames[:-1], frames[1:])
            t_norm = float(np.mean(np.linalg.norm(pose6[:, 3:], axis=-1)))
            d_med = float(np.median(depth))
            d_mean = float(np.mean(depth))  # the loss term uses the mean
            rec = {
                "run": run,
                "mean_t": round(t_norm, 6),
                "median_depth": round(d_med, 5),
                "mean_depth": round(d_mean, 5),
                "r_median": round(t_norm / d_med, 6),
                "r": round(t_norm / d_mean, 6),
            }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.gauge_probe", description=__doc__)
    parser.add_argument("root", nargs="?", default="runs/ablate")
    parser.add_argument("n_frames", nargs="?", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.root, args.n_frames, args.device)
