"""DCDP / LCC ablation grid (port of ``scripts/ablate.py``): the
reference's two headline claims, measured.

The reference claims that the DCDP coupling aligns the geometric
projections and that LCC absorbs brightness variations. Both are config
knobs (``model.dcdp_fusion``, ``loss.lcc``); this script trains the grid of
them, and the protocol arms around it, on the rendered colon corpus and
evaluates each cell on the held-out sequence (seed 999: depth Abs-Rel & co,
ATE and RPE, polyp localisation error).

A cell trains ``steps`` steps on ``N_SEQUENCES`` rendered sequences of
``N_FRAMES`` frames (seeds ``100 + 7·i``, with the cell's per-frame
exposure gain) held on the device (``data.loader="device"``), metrics
every 500 steps and one checkpoint at the end, then exports its weights as
the reference's ``.npz`` and runs ``pipelines.evaluate_synthetic`` on
them. Only the training seed varies between a cell's seeds: corpus and
held-out sequence stay fixed, so the spread measures training alone.

Under ``out_root`` (``runs/ablate``), a directory a cell (``<name>`` at
seed 42, ``<name>_s<seed>`` otherwise): ``train/``, ``ckpt/``,
``weights.npz``, ``eval/`` and ``result.json``; after every cell
``ABLATION.md`` and ``ablation.jsonl`` are written anew from every
finished cell. A cell with a ``result.json`` is not run again; one with
weights but no result is evaluated only (``train_s`` = -1), so a sweep
resumes where it stopped.

Run: ``python -m colvo_torch.scripts.ablate [steps] [out_root] [--device
cuda|cpu] [--cells N]`` (4000 steps, the 27 cell-seeds in priority order;
``--cells N`` runs the first N of them).
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.pipelines import evaluate_synthetic
from colvo_torch.runtime import export_npz
from colvo_torch.runtime import train as train_loop

N_SEQUENCES, N_FRAMES = 8, 64  # the training corpus: rendered sequences × frames

# A cell whose rotation drift exceeds this never converged to a usable VO
# solution: its other metrics describe a diverged model, so it is flagged
# and kept out of the converged means.
DIVERGED_RPE_ROT_DEG = 30.0

SEEDS = (42, 7, 1234)  # the training seeds of a statistical cell


def corpus(cfg: ColvoConfig, exp_jitter: float) -> SnippetDataset:
    """The ablation's training corpus at ``cfg``'s frame size."""
    seqs, ks = [], []
    for i in range(N_SEQUENCES):
        seq = render_sequence(n_frames=N_FRAMES, height=cfg.data.height, width=cfg.data.width,
                              seed=100 + 7 * i, exposure_jitter=exp_jitter)
        seqs.append(seq.frames)
        ks.append(seq.k)
    return SnippetDataset(seqs, ks, cfg.data.frame_offsets)


def release(device: torch.device) -> None:
    """Give back what a finished stage held: the captured programs (the
    step's, the store's batch, the runner's) sit in reference cycles with
    their model, and their graphs' memory pools go with them."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(dcdp: bool, lcc: bool, steps: int, out_root: str,
             geo_cap: Optional[int] = None, geo_w: Optional[float] = None,
             name: Optional[str] = None, exp_jitter: float = 0.0, seed: int = 42,
             lcc_mode: Optional[str] = None, overrides: Optional[dict] = None,
             device: str | torch.device = "cuda") -> dict:
    """Train, export and evaluate one cell (or resume it); returns its
    record, which ``result.json`` holds.

    Args:
        dcdp, lcc: ``model.dcdp_fusion`` and ``loss.lcc``.
        geo_cap, geo_w, lcc_mode: ``loss.geo_res_cap``,
            ``loss.geometric_weight`` and ``loss.lcc_mode`` where given.
        name: the cell's name (``dcdp<d>_lcc<l>`` by default).
        exp_jitter: per-frame exposure gain U(1-j, 1+j) on the training
            corpus and the held-out sequence.
        seed: ``train.seed`` (weights' init and the batch order).
        overrides: more knobs as ``{"section.attr": value}``.
    """
    device = resolve_device(device)
    name = name or f"dcdp{int(dcdp)}_lcc{int(lcc)}"
    # seed 42 keeps the plain cell name; the other seeds get a suffix
    cell_dir = name if seed == 42 else f"{name}_s{seed}"
    out_dir = os.path.join(out_root, cell_dir)
    done_path = os.path.join(out_dir, "result.json")
    if os.path.exists(done_path):  # resume: a finished cell is not run again
        with open(done_path) as f:
            rec = json.load(f)
        print(json.dumps(rec), flush=True)
        return rec
    cfg = ColvoConfig()
    cfg.train.seed = seed
    cfg.model.dcdp_fusion = dcdp
    cfg.loss.lcc = lcc
    if lcc_mode is not None:
        cfg.loss.lcc_mode = lcc_mode
    if geo_cap is not None:
        cfg.loss.geo_res_cap = geo_cap
    if geo_w is not None:
        cfg.loss.geometric_weight = geo_w
    for dotted, v in (overrides or {}).items():  # e.g. {"loss.photo_native": True}
        sect, attr = dotted.split(".")
        setattr(getattr(cfg, sect), attr, v)
    cfg.data.loader = "device"
    cfg.train.ckpt_dir = os.path.join(out_dir, "ckpt")
    cfg.train.log_every = 500
    cfg.train.ckpt_every_steps = steps

    weights = os.path.join(out_dir, "weights.npz")
    if os.path.exists(weights):
        train_s = -1  # trained before, stopped while evaluating
    else:
        ds = corpus(cfg, exp_jitter)
        t0 = time.time()
        model, state = train_loop(cfg, ds, log_dir=os.path.join(out_dir, "train"),
                                  max_steps=steps, device=device)
        train_s = time.time() - t0
        weights = export_npz(model.state_dict(), weights)
        del model, state, ds
        release(device)
    metrics = evaluate_synthetic(cfg, weights=weights, out_dir=os.path.join(out_dir, "eval"),
                                 exposure_jitter=exp_jitter, device=device)
    release(device)
    rec = {"cell": name, "seed": seed, "dcdp": dcdp, "lcc": lcc,
           "steps": steps, "train_s": round(train_s),
           **{k: round(v, 4) for k, v in metrics.items()}}
    with open(done_path, "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    return rec


def aggregate(out_root: str, steps: int) -> None:
    """Aggregate every finished cell under ``out_root`` into ``ABLATION.md``
    and ``ablation.jsonl`` (called after every cell, so that a partial sweep
    always has a current table): mean ± std over a cell's converged seeds,
    diverged seeds flagged and kept out of the statistics."""
    recs = []
    for p in sorted(glob.glob(os.path.join(out_root, "*", "result.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    if not recs:
        return
    keys = [k for k in recs[0] if k not in ("cell", "seed", "dcdp", "lcc",
                                            "steps", "train_s")]
    by_cell = {}
    for r in recs:
        by_cell.setdefault(r["cell"], []).append(r)
    lines = ["# DCDP / LCC ablation + geo-cap A/B (synthetic colon benchmark)",
             "",
             f"{len(by_cell)} cells x {steps} steps; statistical cells "
             f"run up to {len(SEEDS)} seeds {list(SEEDS)} (mean +/- std "
             "over CONVERGED seeds; a seed counts as diverged when "
             f"rpe_rot_deg > {DIVERGED_RPE_ROT_DEG}). Only the training "
             "seed varies — corpus and held-out eval sequence (seed 999) "
             "stay fixed. Lower is better for all error metrics.",
             "",
             "| cell | seeds (conv/total) | " + " | ".join(keys) + " |",
             "|---|---|" + "---|" * len(keys)]
    for cell, rs in by_cell.items():
        conv = [r for r in rs if r["rpe_rot_deg"] <= DIVERGED_RPE_ROT_DEG]
        use = conv or rs  # an all-diverged cell is reported, flagged
        cols = []
        for k in keys:
            vals = np.array([r[k] for r in use], dtype=np.float64)
            if len(use) > 1:
                cols.append(f"{vals.mean():.4f}±{vals.std(ddof=1):.4f}")
            else:
                cols.append(f"{vals.mean():.4f}")
        flag = "" if conv == rs else " ⚠diverged" if not conv else " ⚠"
        lines.append(f"| {cell}{flag} | {len(conv)}/{len(rs)} | "
                     + " | ".join(cols) + " |")
    with open(os.path.join(out_root, "ABLATION.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_root, "ablation.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _headline(seed: int) -> List[dict]:
    return [
        dict(dcdp=True, lcc=True, seed=seed),
        dict(dcdp=True, lcc=True, seed=seed, exp_jitter=0.35, name="expjit_dcdp1_lcc1"),
        dict(dcdp=True, lcc=False, seed=seed, exp_jitter=0.35, name="expjit_dcdp1_lcc0"),
        dict(dcdp=True, lcc=True, seed=seed, exp_jitter=0.35, lcc_mode="global+affine",
             name="expjit_dcdp1_lccG"),
    ]


def _grid_rest(seed: int) -> List[dict]:
    return [
        dict(dcdp=False, lcc=True, seed=seed),  # the headline -DCDP row
        dict(dcdp=True, lcc=False, seed=seed),
        dict(dcdp=False, lcc=False, seed=seed),
    ]


def cells() -> List[dict]:
    """The grid in priority order, so that a partial sweep has multi-seed
    statistics for the claims that matter most first:

    - the 2×2 DCDP/LCC grid at seed 42;
    - LCC in its intended regime: a per-frame auto-exposure gain
      U(0.65, 1.35) on training and evaluation (the headlight falloff alone
      is consistent between frames), with per-pixel LCC, without, and with
      the per-frame global affine mode (``lccG``);
    - ``loss.photo_native`` at one seed;
    - the headline cells at the other seeds;
    - single-seed protocol arms: the geo grid capped at 64 and at 128 (three
      seeds), the geo term off;
    - the rest of the grid at the other seeds.
    """
    return (
        _headline(SEEDS[0]) + _grid_rest(SEEDS[0])
        + [dict(dcdp=True, lcc=True, name="dcdp1_lcc1_pnative",
                overrides={"loss.photo_native": True})]
        + [c for s in SEEDS[1:] for c in _headline(s)]
        + [dict(dcdp=True, lcc=True, geo_cap=64, name="dcdp1_lcc1_geocap64"),
           dict(dcdp=True, lcc=True, geo_cap=128, name="dcdp1_lcc1_geocap128"),
           dict(dcdp=True, lcc=True, geo_cap=128, seed=7, name="dcdp1_lcc1_geocap128"),
           dict(dcdp=True, lcc=True, geo_cap=128, seed=1234, name="dcdp1_lcc1_geocap128"),
           dict(dcdp=True, lcc=True, geo_w=0.0, name="dcdp1_lcc1_geow0")]
        + [c for s in SEEDS[1:] for c in _grid_rest(s)]
    )


def run_queue(queue: List[dict], steps: int, out_root: str, device: str) -> None:
    """Each cell of ``queue`` in order, the tables written after each."""
    resolve_device(device)  # no card: raise before any work
    os.makedirs(out_root, exist_ok=True)
    for cell in queue:
        run_cell(steps=steps, out_root=out_root, device=device, **cell)
        aggregate(out_root, steps)


def main(steps: int = 4000, out_root: str = "runs/ablate", device: str = "cuda",
         n_cells: Optional[int] = None) -> None:
    run_queue(cells()[:n_cells], steps, out_root, device)
    print(f"wrote {out_root}/ABLATION.md")


def parser(prog: str, out_root: str, doc: str) -> argparse.ArgumentParser:
    """The queues' command line: ``[steps] [out_root] [--device]``."""
    p = argparse.ArgumentParser(prog=prog, description=doc)
    p.add_argument("steps", nargs="?", type=int, default=4000)
    p.add_argument("out_root", nargs="?", default=out_root)
    p.add_argument("--device", default="cuda")
    return p


if __name__ == "__main__":
    p = parser("colvo_torch.scripts.ablate", "runs/ablate", __doc__)
    p.add_argument("--cells", type=int, default=None,
                   help="run only the first N cells of the priority order")
    args = p.parse_args(sys.argv[1:])
    main(args.steps, args.out_root, args.device, args.cells)
