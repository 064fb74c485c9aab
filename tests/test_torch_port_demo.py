"""The README's end-to-end workflows on colvo_torch, on the CPU at a tiny
size: ``colvo_torch.scripts.demo_synthetic.main`` against direct calls of
the port's own pipeline (the reference's demo trains from its own Flax
init, so its numbers cannot be the port's), and
``colvo_torch.scripts.fullcolon.main`` against the reference's
``scripts/fullcolon.py`` driven in process on the same weights: the JSON
record's trajectory, cloud and polyp numbers."""

import gzip
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import colvo.config
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.data.png import read_png
from colvo_torch.models import ColVOModel
from colvo_torch.pipelines import evaluate_synthetic, make_runner, make_training_eval_hook
from colvo_torch.runtime import export_npz, load_npz
from colvo_torch.runtime import train as train_loop
from colvo_torch.scripts import demo_synthetic, fullcolon
from colvo_torch.vo import load_ply

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96
N_SEQUENCES, N_FRAMES = 2, 6  # 8 snippets: 4 steps an epoch at B=2
STEPS = 4
FULLCOLON_FRAMES = 24


def small(cls=ColvoConfig):
    def make():
        cfg = cls()
        cfg.model.dtype = "float32"
        cfg.data.height, cfg.data.width, cfg.data.batch_size = H, W, 2
        return cfg
    return make


# TensorBoard's import loads TensorFlow (and JAX with it) for ~20 s; the
# writer takes its absence as the reference's does.
NO_TENSORBOARD = {"torch.utils.tensorboard": None}


def test_demo_main_runs_end_to_end_and_equals_its_pipeline(tmp_path):
    """``main`` trains on the device loader with the eval hook, exports and
    evaluates; its artifacts are on disk, and its weights, eval rows and
    metrics equal those of the same calls made directly."""
    out = tmp_path / "demo"
    with mock.patch.object(demo_synthetic, "ColvoConfig", small()), \
            mock.patch.object(demo_synthetic, "N_SEQUENCES", N_SEQUENCES), \
            mock.patch.object(demo_synthetic, "N_FRAMES", N_FRAMES), \
            mock.patch.dict(sys.modules, NO_TENSORBOARD):
        got = demo_synthetic.main(STEPS, str(out), "cpu", eval_every_epochs=1)

    rows = [json.loads(line) for line in open(out / "train" / "metrics.jsonl")]
    evals = [r for r in rows if "eval/abs_rel" in r]
    assert [r["step"] for r in evals] == [STEPS]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step")
    for tag in ("disp", "automask", "warp_error"):
        assert read_png(str(out / "train" / f"panels_{tag}_{STEPS:08d}.png")).shape == (H, W, 3)
    assert os.listdir(out / "ckpt") == [str(STEPS)]
    for name in ("qualitative_depth.png", "trajectory_predictions.png",
                 "colon_reconstruction.png", "reconstruction.ply", "metrics.json"):
        assert (out / "eval" / name).is_file(), name
    assert json.load(open(out / "eval" / "metrics.json")) == pytest.approx(got)
    assert np.isfinite(list(got.values())).all() and "polyp/e_mean" in got
    make_runner(small()(), str(out / "weights.npz"), device="cpu")

    # the same pipeline, called directly
    cfg = small()()
    cfg.data.loader = "device"
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    cfg.train.log_every, cfg.train.ckpt_every_steps = 500, STEPS
    cfg.train.eval_every_epochs = 1
    seqs = [render_sequence(n_frames=N_FRAMES, height=H, width=W, seed=100 + 7 * i)
            for i in range(N_SEQUENCES)]
    ds = SnippetDataset([s.frames for s in seqs], [s.k for s in seqs], cfg.data.frame_offsets)
    with mock.patch.dict(sys.modules, NO_TENSORBOARD):
        _, state = train_loop(cfg, ds, log_dir=str(tmp_path / "train"), max_steps=STEPS,
                              eval_hook_factory=make_training_eval_hook, device="cpu")
    weights = export_npz(state.model.state_dict(), str(tmp_path / "weights.npz"))
    want = evaluate_synthetic(cfg, weights=weights, out_dir=str(tmp_path / "eval"), device="cpu")

    a, b = load_npz(str(out / "weights.npz")), load_npz(weights)
    assert all(torch.equal(a[k], b[k]) for k in b)
    want_evals = [json.loads(line) for line in open(tmp_path / "train" / "metrics.jsonl")]
    want_evals = [r for r in want_evals if "eval/abs_rel" in r]
    for r, w in zip(evals, want_evals):
        assert {k: v for k, v in r.items() if k != "time"} == {
            k: v for k, v in w.items() if k != "time"}
    assert got == want


def test_demo_main_parses_its_command_line(tmp_path):
    """``python -m colvo_torch.scripts.demo_synthetic [steps] [out_dir]
    [--device]``: without a card, ``cuda`` (the default) raises before any
    work."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    import subprocess

    run = subprocess.run([sys.executable, "-m", "colvo_torch.scripts.demo_synthetic", "3",
                          str(tmp_path / "d")], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and "device='cpu'" in run.stderr
    assert not (tmp_path / "d").exists()


@pytest.fixture(scope="module")
def fullcolon_runs(tmp_path_factory):
    """The reference's and the port's ``main`` at FULLCOLON_FRAMES frames
    of 64×96 on the same exported weights; the reference's render cache
    (a fixed path under /tmp) is neither read nor written, the port's
    lies in the test's temporary directory."""
    tmp = tmp_path_factory.mktemp("fullcolon")
    model = ColVOModel(small()().model)
    model.reset_parameters(torch.Generator().manual_seed(0))
    weights = export_npz(model.state_dict(), str(tmp / "weights.npz"))

    spec = importlib.util.spec_from_file_location("reference_fullcolon",
                                                  ROOT / "scripts" / "fullcolon.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    exists, savez = os.path.exists, np.savez

    def cache(path):
        return str(path).startswith("/tmp/longvideo_")

    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(sys, "argv", ["fullcolon.py", str(FULLCOLON_FRAMES), weights,
                                            str(tmp / "ref")]), \
            mock.patch.object(os.path, "exists", lambda p: False if cache(p) else exists(p)), \
            mock.patch.object(np, "savez", lambda p, **kw: None if cache(p) else savez(p, **kw)):
        ref.main()
    with mock.patch.object(fullcolon, "ColvoConfig", small()), \
            mock.patch.object(tempfile, "tempdir", str(tmp)):
        got = fullcolon.main(FULLCOLON_FRAMES, weights, str(tmp / "port"), "cpu")
    want = json.load(open(tmp / "ref" / "fullcolon.json"))
    return tmp, got, want


def test_fullcolon_main_matches_the_reference(fullcolon_runs):
    """ATE, RPE (before and after the default's no-refinement), every polyp
    error and its diagnostics, and the two clouds' sizes: the reference's
    to 1e-3 relative, at the record's own rounding."""
    _, got, want = fullcolon_runs
    keys = [k for k in want if k.split("/")[0] in ("ate", "rpe_trans", "rpe_rot_deg", "raw")
            or k.startswith("rpe_") or (k.startswith("polyp/e"))]
    assert {"ate", "raw/ate", "polyp/e1", "polyp/e3", "polyp/e_mean"} <= set(keys)
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=0), (k, got[k], want[k])
    assert got["polyp/diag"] == want["polyp/diag"]
    for k in ("n_points_ours", "n_points_gt", "n_frames", "keyframe_every", "voxel", "wire",
              "symmetric_pose"):
        assert got[k] == want[k], k


def test_fullcolon_main_writes_its_artifacts(fullcolon_runs):
    """The JSON record, the markdown summary, the figure and the gzipped
    PLY (whose point count is the record's) under ``out_dir``; the render
    cache in the temporary directory; every number finite."""
    tmp, got, _ = fullcolon_runs
    out = tmp / "port"
    assert json.load(open(out / "fullcolon.json")) == got
    assert "ATE" in (out / "FULLCOLON.md").read_text()
    assert read_png(str(out / "fullcolon_recon.png")).ndim == 3
    with gzip.open(out / "fullcolon_ours.ply.gz", "rb") as f:
        (tmp / "ours.ply").write_bytes(f.read())
    assert len(load_ply(str(tmp / "ours.ply")).points) == got["n_points_ours"] > 0
    assert got["n_points_gt"] > 0
    assert (tmp / f"longvideo_{FULLCOLON_FRAMES}_{H}x{W}.npz").is_file()
    assert all(np.isfinite(v) for k, v in got.items()
               if isinstance(v, float) and k != "rss_mb_end")
