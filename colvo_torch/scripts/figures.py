"""Figures that compare methods, from the trained ablation cells (port of
``scripts/figures.py``).

The reference's evaluation figures compare many methods (its qualitative
depth rows and its trajectory legend); ``viz_depth_grid`` and
``viz_trajectory`` take a dict of methods for that. This draws them with
the ablation's cells as the methods (``METHODS``: full, -DCDP, -LCC, the
geo cap, the exposure-jittered cells) on the held-out sequence (seed 999,
48 frames): frame 0's predicted depth a method, and each method's
trajectory from one batched pose call over the consecutive pairs,
chained and sim(3)-aligned to the ground truth. A cell whose weights are
missing is skipped; fewer than two methods draw nothing.

Writes ``qualitative_depth_methods.png`` and ``trajectories_methods.png``
under ``out_dir`` (``runs/figures``) from ``<ablate_root>/<cell>/weights.npz``
(``colvo_torch.scripts.ablate``).

Run: ``python -m colvo_torch.scripts.figures [ablate_root] [out_dir]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.synthetic import render_sequence
from colvo_torch.evaluation.viz import viz_depth_grid, viz_trajectory
from colvo_torch.pipelines import make_runner
from colvo_torch.vo import align_trajectory, chain_relative_poses

# method label -> (cell directory, the config overrides it was trained with)
METHODS = {
    "ColVO(ours)": ("dcdp1_lcc1", []),
    "-DCDP": ("dcdp0_lcc1", ["--model.dcdp_fusion=false"]),
    "-LCC": ("dcdp1_lcc0", ["--loss.lcc=false"]),
    "geo capped@64": ("dcdp1_lcc1_geocap64", ["--loss.geo_res_cap=64"]),
    "expjit-trained": ("expjit_dcdp1_lcc1", []),
    "expjit-trained -LCC": ("expjit_dcdp1_lcc0", ["--loss.lcc=false"]),
    "expjit-trained LCC-global": ("expjit_dcdp1_lccG",
                                  ["--loss.lcc_mode=global+affine"]),
}
HELD_OUT_SEED, HELD_OUT_FRAMES = 999, 48


def main(root: str = "runs/ablate", out_dir: str = "runs/figures",
         device: str = "cuda") -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
    """Draw the two figures; returns (frame 0's depth by method, the
    aligned trajectories with the ground truth), or None with fewer than
    two methods."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg0 = ColvoConfig()
    seq = render_sequence(n_frames=HELD_OUT_FRAMES, height=cfg0.data.height,
                          width=cfg0.data.width, seed=HELD_OUT_SEED)

    preds, trajs = {}, {"Ground Truth": seq.poses[:, :3, 3].astype(np.float64)}
    for label, (cell, overrides) in METHODS.items():
        weights = os.path.join(root, cell, "weights.npz")
        if not os.path.exists(weights):
            print(f"skip {label}: {weights} missing", flush=True)
            continue
        cfg = ColvoConfig()
        if overrides:
            cfg.apply_overrides(overrides)
        runner = make_runner(cfg, weights, device)
        depth, _ = runner.infer_depth(seq.frames[:1])
        preds[label] = np.asarray(depth[0])
        # one batched pose call over every consecutive pair, then the chain
        # and the alignment on the host
        rel6 = runner.infer_pose(seq.frames[:-1], seq.frames[1:])
        poses = chain_relative_poses(np.asarray(rel6))
        trajs[label] = align_trajectory(poses[:, :3, 3],
                                        seq.poses[: len(poses), :3, 3].astype(np.float64))
        print(f"{label}: done", flush=True)

    if len(preds) < 2:
        print("fewer than 2 methods available — train cells first")
        return None
    viz_depth_grid(seq.frames[0], seq.depths[0], preds,
                   os.path.join(out_dir, "qualitative_depth_methods.png"),
                   max_depth=cfg0.eval.depth_cap)
    viz_trajectory(trajs, os.path.join(out_dir, "trajectories_methods.png"))
    print(f"wrote {out_dir}/qualitative_depth_methods.png + trajectories_methods.png")
    return preds, trajs


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.figures", description=__doc__)
    parser.add_argument("root", nargs="?", default="runs/ablate")
    parser.add_argument("out_dir", nargs="?", default="runs/figures")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.root, args.out_dir, args.device)
