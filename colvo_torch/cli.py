"""CLI entry points (port of ``colvo/cli.py``).

``python -m colvo_torch.cli <command> [--config cfg.json] [--device cuda|cpu]
[--section.key=value ...]``

Commands: train · export. The reference's infer, vo, recon, eval, viz and
import-torch are not ported yet (ROADMAP.md §A.3, §A.6). Every command runs
on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from colvo_torch.config import ColvoConfig


def _load_cfg(args, overrides) -> ColvoConfig:
    cfg = ColvoConfig.load(args.config) if args.config else ColvoConfig()
    if overrides:
        cfg.apply_overrides(overrides)
    return cfg


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="colvo_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="DCDP+LCC self-supervised training")
    p_train.add_argument("--config")
    p_train.add_argument("--log-dir", default="runs/train")
    p_train.add_argument("--max-steps", type=int, default=None)
    p_train.add_argument("--resume", action="store_true")
    p_train.add_argument("--device", default="cuda")

    p_export = sub.add_parser("export", help="export inference weights (.npz) from a checkpoint")
    p_export.add_argument("ckpt_dir")
    p_export.add_argument("out", help="output .npz path")
    p_export.add_argument("--config")

    args, overrides = parser.parse_known_args(argv)

    if args.command == "train":
        cfg = _load_cfg(args, overrides)
        from colvo_torch.pipelines import train

        train(cfg, log_dir=args.log_dir, max_steps=args.max_steps, resume=args.resume,
              device=args.device)
    elif args.command == "export":
        cfg = _load_cfg(args, overrides)
        from colvo_torch.runtime import (CheckpointManager, export_npz, flax_params,
                                         params_from_flax)

        mgr = CheckpointManager(args.ckpt_dir)
        payload, step, _ = mgr.load()
        mgr.close()
        # raises unless the checkpoint holds exactly the configured model
        state_dict = params_from_flax(flax_params(payload["model"]), cfg.model)
        out = export_npz(state_dict, args.out)
        print(f"exported step-{step} params to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
