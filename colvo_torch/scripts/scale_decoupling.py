"""Depth<->pose scale decoupling, measured (port of
``scripts/scale_decoupling.py``).

In the reference's round-4 ablation three seed-runs held good rotation
but 30-50× the polyp error of their siblings. The hypothesis: their depth
scale drifted away from their translation scale, which median-scaled
depth metrics and sim(3)-aligned ATE cannot see but polyp localisation
(depth lifted through the scaled pose) can. For each run of ``RUNS`` this
measures the two scales apart on the held-out sequence (seed 999, 48
frames; with the exposure gain for the jittered cells):

    s_traj  = the Umeyama sim(3) scale from predicted to GT positions
    s_depth = the median over frames of median(GT depth) / median(predicted)

A model with one shared gauge has s_traj / s_depth near 1. Runs whose
weights are missing are skipped; ``polyp_e_mean`` comes from the run's
``result.json``.

Writes the table to ``out_md`` (``<ablate_root>/SCALE_DECOUPLING.md``).

Run: ``python -m colvo_torch.scripts.scale_decoupling [ablate_root]
[out_md] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.synthetic import render_sequence
from colvo_torch.pipelines import make_runner
from colvo_torch.vo import run_vo, umeyama

# (run dir, evaluated on the jittered sequence, config overrides): the
# decoupled runs and their well-behaved sibling seeds
RUNS = [
    ("expjit_dcdp1_lccG", True, ["--loss.lcc_mode=global+affine"]),
    ("expjit_dcdp1_lccG_s1234", True, ["--loss.lcc_mode=global+affine"]),
    ("expjit_dcdp1_lccG_s7", True, ["--loss.lcc_mode=global+affine"]),
    ("dcdp0_lcc0", False, ["--model.dcdp_fusion=false", "--loss.lcc=false"]),
    ("dcdp0_lcc0_s1234", False,
     ["--model.dcdp_fusion=false", "--loss.lcc=false"]),
    ("dcdp1_lcc1", False, []),
]


def held_out(cfg: ColvoConfig, n_frames: int) -> dict:
    """The held-out sequence, clean (False) and with the exposure gain of
    0.35 (True)."""
    return {jit: render_sequence(n_frames, cfg.data.height, cfg.data.width, seed=999,
                                 exposure_jitter=0.35 if jit else 0.0)
            for jit in (False, True)}


def main(root: str = "runs/ablate", out_md: Optional[str] = None,
         device: str = "cuda") -> List[dict]:
    """Measure every run present; returns the table's rows."""
    device = resolve_device(device)
    out_md = out_md or os.path.join(root, "SCALE_DECOUPLING.md")
    seqs = held_out(ColvoConfig(), 48)

    rows = []
    for run, jit_arm, overrides in RUNS:
        weights = os.path.join(root, run, "weights.npz")
        res_path = os.path.join(root, run, "result.json")
        if not os.path.exists(weights):
            print(f"skip {run}: {weights} missing", flush=True)
            continue
        cfg = ColvoConfig()
        if overrides:
            cfg.apply_overrides(overrides)
        runner = make_runner(cfg, weights, device)
        seq = seqs[jit_arm]
        vo = run_vo(runner, list(seq.frames), keyframe_every=1)
        _, _, s_traj = umeyama(vo.poses[:, :3, 3], seq.poses[:, :3, 3].astype(np.float64))
        s_depth = float(np.median([np.median(seq.depths[i]) / max(np.median(d), 1e-9)
                                   for i, d in enumerate(vo.depths)]))
        polyp_e = float("nan")
        if os.path.exists(res_path):
            with open(res_path) as f:
                polyp_e = json.load(f).get("polyp/e_mean", float("nan"))
        row = {
            "run": run,
            "eval_arm": "expjit" if jit_arm else "clean",
            "s_traj": round(float(s_traj), 4),
            "s_depth": round(s_depth, 4),
            "decoupling": round(float(s_traj) / s_depth, 3),
            "polyp_e_mean": round(polyp_e, 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not rows:
        print("no runs available")
        return rows

    lines = [
        "# Depth<->pose scale decoupling — measured",
        "",
        "`s_traj` (Umeyama sim(3) trajectory scale) vs `s_depth` (median "
        "GT/pred depth ratio) on the held-out sequence; a scale-consistent "
        "model shares one gauge so `s_traj / s_depth ~= 1`. The ablation's "
        "polyp-e blowups (docs/ABLATION.md section 6) should — and the "
        "well-behaved sibling seeds should NOT — show ratios far from 1.",
        "",
        "| run | eval arm | s_traj | s_depth | s_traj/s_depth | polyp e_mean |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['run']} | {r['eval_arm']} | {r['s_traj']} | "
            f"{r['s_depth']} | **{r['decoupling']}** | {r['polyp_e_mean']} |"
        )
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_md}")
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.scale_decoupling",
                                     description=__doc__)
    parser.add_argument("root", nargs="?", default="runs/ablate")
    parser.add_argument("out_md", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.root, args.out_md, args.device)
