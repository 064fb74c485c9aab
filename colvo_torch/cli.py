"""CLI entry points (port of ``colvo/cli.py``).

``python -m colvo_torch.cli <command> [--config cfg.json] [--device cuda|cpu]
[--section.key=value ...]``

Commands: train · infer · vo · recon · eval · viz · export · import-torch,
as the reference's. Every command but ``export`` takes ``--device`` and
runs on ``cuda`` unless ``--device cpu`` is given (``viz`` and
``import-torch`` do their work on the host, but keep the rule); ``export``
converts a checkpoint on the host. ``train`` under ``torchrun``
(``python -m torch.distributed.run --nproc_per_node=N -m colvo_torch.cli
train ...``) is data parallel over the N ranks (``runtime/mesh.py``).
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

    p_infer = sub.add_parser("infer", help="single-frame depth inference")
    p_infer.add_argument("frames", help="frame dir or video file")
    p_infer.add_argument("--config")
    p_infer.add_argument("--weights")
    p_infer.add_argument("--out", default="runs/infer")
    p_infer.add_argument("--device", default="cuda")

    p_vo = sub.add_parser("vo", help="full-sequence VO")
    p_vo.add_argument("frames", nargs="?", default=None,
                      help="frame dir / video (default: synthetic demo)")
    p_vo.add_argument("--config")
    p_vo.add_argument("--weights")
    p_vo.add_argument("--out", default="runs/vo")
    p_vo.add_argument("--no-recon", action="store_true")
    p_vo.add_argument("--device", default="cuda")

    p_recon = sub.add_parser("recon", help="VO + 3D reconstruction → PLY")
    p_recon.add_argument("frames", nargs="?", default=None)
    p_recon.add_argument("--config")
    p_recon.add_argument("--weights")
    p_recon.add_argument("--out", default="runs/recon")
    p_recon.add_argument("--device", default="cuda")

    p_eval = sub.add_parser("eval", help="depth+pose evaluation with figures")
    p_eval.add_argument("--config")
    p_eval.add_argument("--weights")
    p_eval.add_argument("--out", default="runs/eval")
    p_eval.add_argument("--data", default=None,
                        help="benchmark dir (VCD/CSD-style layout, see "
                        "colvo_torch/data/benchmark.py); default: synthetic eval")
    p_eval.add_argument("--sequences", default=None,
                        help="comma-separated sequence subset")
    p_eval.add_argument("--device", default="cuda")

    p_viz = sub.add_parser("viz", help="regenerate figures from a VO run dir")
    p_viz.add_argument("run_dir")
    p_viz.add_argument("--device", default="cuda")

    p_export = sub.add_parser("export", help="export inference weights (.npz) from a checkpoint")
    p_export.add_argument("ckpt_dir")
    p_export.add_argument("out", help="output .npz path")
    p_export.add_argument("--config")

    p_imp = sub.add_parser(
        "import-torch",
        help="convert a family PyTorch checkpoint dir (encoder.pth/depth.pth"
        "[/pose_encoder.pth/pose.pth]) to inference weights (.npz)",
    )
    p_imp.add_argument("torch_dir")
    p_imp.add_argument("out", help="output .npz path")
    p_imp.add_argument("--config")
    p_imp.add_argument("--device", default="cuda")

    args, overrides = parser.parse_known_args(argv)

    if args.command == "train":
        cfg = _load_cfg(args, overrides)
        import torch

        from colvo_torch.runtime.mesh import maybe_init_distributed

        # the process group, when a torch.distributed launcher started us
        joined = maybe_init_distributed(
            "gloo" if torch.device(args.device).type == "cpu" else None)
        from colvo_torch.pipelines import train

        try:
            train(cfg, log_dir=args.log_dir, max_steps=args.max_steps, resume=args.resume,
                  device=args.device)
        finally:
            if joined:
                torch.distributed.destroy_process_group()
    elif args.command == "infer":
        cfg = _load_cfg(args, overrides)
        from colvo_torch.pipelines import infer_depth

        infer_depth(cfg, args.frames, args.out, args.weights, device=args.device)
    elif args.command in ("vo", "recon"):
        cfg = _load_cfg(args, overrides)
        from colvo_torch.pipelines import run_vo_pipeline

        run_vo_pipeline(
            cfg, args.frames, out_dir=args.out, weights=args.weights,
            reconstruct=not getattr(args, "no_recon", False), device=args.device,
        )
    elif args.command == "eval":
        cfg = _load_cfg(args, overrides)
        if args.data:
            from colvo_torch.pipelines import evaluate_dataset

            seqs = args.sequences.split(",") if args.sequences else None
            metrics = evaluate_dataset(cfg, args.data, weights=args.weights, out_dir=args.out,
                                       sequences=seqs, device=args.device)
        else:
            from colvo_torch.pipelines import evaluate_synthetic

            metrics = evaluate_synthetic(cfg, weights=args.weights, out_dir=args.out,
                                         device=args.device)
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")
    elif args.command == "viz":
        import os

        import numpy as np

        from colvo_torch import resolve_device
        from colvo_torch.evaluation.viz import viz_trajectory

        resolve_device(args.device)
        poses = np.load(os.path.join(args.run_dir, "trajectory.npy"))
        viz_trajectory({"ColVO(ours)": poses[:, :3, 3]},
                       os.path.join(args.run_dir, "trajectory.png"))
        print(f"wrote {args.run_dir}/trajectory.png")
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
    elif args.command == "import-torch":
        import torch

        from colvo_torch import resolve_device
        from colvo_torch.models import ColVOModel
        from colvo_torch.runtime import export_npz
        from colvo_torch.runtime.torch_import import (import_family_checkpoint,
                                                      load_family_checkpoint_dir)

        resolve_device(args.device)
        cfg = _load_cfg(args, overrides)
        # Family encoders are Conv→BatchNorm, so the import target is the
        # BN-folded norm="none" model; the family pose decoder takes the
        # bare 512-channel bottleneck, so DCDP fusion is off.
        cfg.model.norm = "none"
        cfg.model.dcdp_fusion = False
        template = ColVOModel(cfg.model)
        template.reset_parameters(torch.Generator().manual_seed(0))
        sds = load_family_checkpoint_dir(args.torch_dir)
        state_dict = import_family_checkpoint(
            template.state_dict(), sds["encoder"], sds["depth"], sds.get("pose_encoder"),
            sds.get("pose"), num_layers=cfg.model.num_layers, n_scales=cfg.model.n_scales,
        )
        out = export_npz(state_dict, args.out)
        print(f"imported family checkpoint {args.torch_dir} -> {out} "
              f"(use with --model.norm=none --model.dcdp_fusion=false)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
