"""The exposure-jitter depth gap split into model quality and frame
hardness (port of ``scripts/expjit_analysis.py``).

The ablation's exposure-jitter cells (``ablate``'s ``expjit_*``) train AND
evaluate under per-frame auto-exposure gain, so their depth numbers mix
two effects:

  (a) did jittered TRAINING degrade the model (LCC's job is to prevent
      exactly this: the photometric loss reading brightness changes as
      signal), and
  (b) are jittered EVALUATION frames harder for any single-frame depth
      net (over- or under-exposed inputs carry less texture: a test-time
      effect no training-loss fix can remove)?

This runs the clean-trained baseline and every expjit-trained cell on BOTH
arms of the same held-out sequence (seed 999, clean and with exposure
jitter 0.35) and writes a markdown cross-table. Effect (a) is the
clean-evaluation column's gap to the baseline; effect (b) each row's
clean→jittered ratio.

Per cell and arm, frame 0's depth and signed error map land in
``<out_dir>/maps/<cell>_<arm>.png`` (the standard evaluation figure), so
the residual's spatial structure can be inspected. A cell without weights
under ``ablate_root`` is skipped. One process builds a runner a cell and
gives its programs back (``ablate.release``) before the next.

Run: ``python -m colvo_torch.scripts.expjit_analysis [ablate_root]
[out_dir] [--device cuda|cpu]`` (``runs/ablate``, ``runs/expjit``: the
table is ``<out_dir>/EXPJIT_DEPTH.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.synthetic import render_sequence
from colvo_torch.evaluation.depth import evaluate_depth
from colvo_torch.evaluation.viz import viz_depth_grid
from colvo_torch.pipelines import make_runner
from colvo_torch.scripts.ablate import release

# (cell dir, config overrides matching training): the clean-trained
# baseline first, then the expjit arms from the weakest prior to the strongest
CELLS = [
    ("dcdp1_lcc1", []),
    ("expjit_dcdp1_lcc0", ["--loss.lcc=false"]),
    ("expjit_dcdp1_lcc1", []),
    ("expjit_dcdp1_lccG", ["--loss.lcc_mode=global+affine"]),
]

KEYS = ("abs_rel", "rmse", "a1")
N_FRAMES = 48  # frames of the held-out sequence
JITTER = 0.35


def main(root: str = "runs/ablate", out_dir: str = "runs/expjit",
         device: str = "cuda") -> List[dict]:
    """Evaluate every cell present on both arms; returns the rows it
    printed (empty when no cell has weights)."""
    device = resolve_device(device)
    maps_dir = os.path.join(out_dir, "maps")
    os.makedirs(maps_dir, exist_ok=True)

    cfg0 = ColvoConfig()
    seqs = {
        "clean": render_sequence(N_FRAMES, cfg0.data.height, cfg0.data.width, seed=999),
        "expjit": render_sequence(N_FRAMES, cfg0.data.height, cfg0.data.width, seed=999,
                                  exposure_jitter=JITTER),
    }

    rows = []
    for cell, overrides in CELLS:
        weights = os.path.join(root, cell, "weights.npz")
        if not os.path.exists(weights):
            print(f"skip {cell}: {weights} missing", flush=True)
            continue
        cfg = ColvoConfig()
        if overrides:
            cfg.apply_overrides(overrides)
        runner = make_runner(cfg, weights, device)
        row = {"cell": cell}
        for arm, seq in seqs.items():
            m, preds = evaluate_depth(runner, seq.frames, seq.depths, cfg)
            row[arm] = {k: round(float(m[k]), 4) for k in KEYS}
            viz_depth_grid(seq.frames[0], seq.depths[0], {cell: preds[0]},
                           os.path.join(maps_dir, f"{cell}_{arm}.png"),
                           max_depth=cfg.eval.depth_cap)
        del runner
        release(device)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not rows:
        print("no cells available")
        return rows

    lines = [
        "# Exposure-jitter depth gap: model quality vs frame hardness",
        "",
        "Same held-out sequence (seed 999) rendered twice — clean and with "
        "per-frame auto-exposure gain U(0.65, 1.35) clipped at sensor "
        "saturation — evaluated by the clean-trained baseline and every "
        "expjit-trained cell. Columns: Abs-Rel / RMSE / δ<1.25 per eval arm.",
        "",
        "| weights (training regime) | clean eval | jittered eval | "
        "clean→jit Abs-Rel × |",
        "|---|---|---|---|",
    ]

    def fmt(a):
        return f"{a['abs_rel']} / {a['rmse']} / {a['a1']}"

    for r in rows:
        ratio = (r["expjit"]["abs_rel"] / r["clean"]["abs_rel"]
                 if r["clean"]["abs_rel"] else float("nan"))
        lines.append(f"| {r['cell']} | {fmt(r['clean'])} | {fmt(r['expjit'])} | {ratio:.2f}× |")
    lines += [
        "",
        "Reading: a cell whose CLEAN-eval Abs-Rel approaches the "
        "clean-trained baseline learned clean geometry despite jittered "
        "training — the training-time damage LCC exists to prevent is "
        "gone, and its remaining jittered-eval gap (the ratio column) is "
        "frame hardness: over/under-exposed inputs carry less usable "
        "texture at test time, which no training-loss calibration can "
        "restore. Signed error maps per cell/arm: `maps/`.",
        "",
    ]
    with open(os.path.join(out_dir, "EXPJIT_DEPTH.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_dir}/EXPJIT_DEPTH.md")
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.expjit_analysis",
                                     description=__doc__)
    parser.add_argument("root", nargs="?", default="runs/ablate")
    parser.add_argument("out_dir", nargs="?", default="runs/expjit")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.root, args.out_dir, args.device)
