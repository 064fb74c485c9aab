"""Levers toward the strong basin (port of ``scripts/basin_levers.py``).

The flagship configuration reaches the strong basin on about two seeds in
three in the reference's ablation (Abs-Rel 0.05-0.12 against ~0.35). This
trains the flagship cell under each candidate lever at the given seeds,
through ``ablate.run_cell``, into ``runs/levers``:

- ``warmup``: ``train.warmup_steps=500`` (a linear warm-up of the rate);
- ``georamp``: ``loss.geo_ramp_steps=500`` (the geo term's weight 0 → 1);
- ``both``: the two together.

Run: ``python -m colvo_torch.scripts.basin_levers [steps] [out_root]
[seed ...] [--levers warmup,georamp] [--device cuda|cpu]`` (4000 steps,
seeds 42 7 1234; ``--levers`` is the reference's ``COLVO_LEVERS``).
"""

from __future__ import annotations

import sys
from typing import Sequence

from colvo_torch.scripts import ablate

LEVERS = {
    "warmup": {"train.warmup_steps": 500},
    "georamp": {"loss.geo_ramp_steps": 500},
    "both": {"train.warmup_steps": 500, "loss.geo_ramp_steps": 500},
}


def lever_cells(levers: Sequence[str], seeds: Sequence[int]) -> list:
    """The flagship under each lever, at each seed, lever by lever."""
    return [dict(dcdp=True, lcc=True, seed=seed, name=f"dcdp1_lcc1_{lever}",
                 overrides=LEVERS[lever]) for lever in levers for seed in seeds]


def main(steps: int = 4000, out_root: str = "runs/levers", seeds: Sequence[int] = (42, 7, 1234),
         levers: Sequence[str] = ("warmup", "georamp"), device: str = "cuda") -> None:
    ablate.run_queue(lever_cells(levers, seeds), steps, out_root, device)


if __name__ == "__main__":
    p = ablate.parser("colvo_torch.scripts.basin_levers", "runs/levers", __doc__)
    p.add_argument("seeds", nargs="*", type=int)
    p.add_argument("--levers", default="warmup,georamp")
    args = p.parse_args(sys.argv[1:])
    main(args.steps, args.out_root, args.seeds or (42, 7, 1234), args.levers.split(","),
         args.device)
