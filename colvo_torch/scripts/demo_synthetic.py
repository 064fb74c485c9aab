"""End-to-end demo (port of ``scripts/demo_synthetic.py``): train on
rendered colon sequences, export the weights, evaluate, figure set.

Trains DCDP+LCC at the default configuration on a corpus of
``N_SEQUENCES`` rendered sequences of ``N_FRAMES`` frames (seeds
``100 + 7·i``) held on the device (``data.loader="device"``), with the
eval hook every ``eval_every_epochs`` epochs, metrics every 500 steps and
one checkpoint at the end; exports the weights as the reference's
``.npz``; then runs ``pipelines.evaluate_synthetic`` (depth metrics, ATE,
polyp errors, the reconstruction and the three reference figures) on the
held-out sequence. Under ``out_dir`` (``runs/demo``): ``train/``
(``metrics.jsonl``, the hook's panels), ``ckpt/``, ``weights.npz`` and
``eval/`` (``metrics.json``, the figures, the PLY).

Run: ``python -m colvo_torch.scripts.demo_synthetic [steps] [out_dir]
[--device cuda|cpu]`` (12000 steps by default, on ``cuda``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.pipelines import evaluate_synthetic, make_training_eval_hook
from colvo_torch.runtime import export_npz
from colvo_torch.runtime import train as train_loop

N_SEQUENCES, N_FRAMES = 8, 64  # the training corpus: rendered sequences × frames


def corpus(cfg: ColvoConfig) -> SnippetDataset:
    """The demo's corpus, richer than the default synthetic dataset."""
    seqs, ks = [], []
    for i in range(N_SEQUENCES):
        seq = render_sequence(n_frames=N_FRAMES, height=cfg.data.height,
                              width=cfg.data.width, seed=100 + 7 * i)
        seqs.append(seq.frames)
        ks.append(seq.k)
    return SnippetDataset(seqs, ks, cfg.data.frame_offsets)


def main(max_steps: int = 12000, out_dir: str = "runs/demo", device: str = "cuda",
         eval_every_epochs: int = 25) -> Dict[str, float]:
    """Train ``max_steps`` steps, export, evaluate; returns the metrics of
    ``evaluate_synthetic``."""
    device = resolve_device(device)
    cfg = ColvoConfig()
    cfg.data.loader = "device"
    cfg.train.ckpt_dir = os.path.join(out_dir, "ckpt")
    cfg.train.log_every = 500
    cfg.train.ckpt_every_steps = max_steps  # the final checkpoint only
    cfg.train.eval_every_epochs = eval_every_epochs  # 25: every ~1k steps on this corpus

    ds = corpus(cfg)
    print(f"corpus: {len(ds)} snippets from {N_SEQUENCES} sequences", flush=True)
    t0 = time.time()
    _, state = train_loop(cfg, ds, log_dir=os.path.join(out_dir, "train"), max_steps=max_steps,
                          eval_hook_factory=make_training_eval_hook, device=device)
    print(f"trained {max_steps} steps in {time.time() - t0:.0f}s", flush=True)
    weights = export_npz(state.model.state_dict(), os.path.join(out_dir, "weights.npz"))

    metrics = evaluate_synthetic(cfg, weights=weights, out_dir=os.path.join(out_dir, "eval"),
                                 device=device)
    for k, v in metrics.items():
        print(f"  {k:16s} {v:.4f}")
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.demo_synthetic",
                                     description=__doc__)
    parser.add_argument("steps", nargs="?", type=int, default=12000)
    parser.add_argument("out_dir", nargs="?", default="runs/demo")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.steps, args.out_dir, args.device)
