"""The long-video drift proof on colvo_torch against the reference's
``scripts/longvideo.py``, driven in process on the CPU at 64×96 and 24
frames over the same exported weights: both arms' rendered frames and
drift curves, and the report (its markdown, and a figure of the
reference's pixel size with its lines where the data puts them). The
reference's render cache, a fixed path under /tmp, is neither read nor
written; the port's lies in the test's temporary directory."""

import json
import os
import shutil
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

import colvo.config
from colvo_torch.data.png import read_png
from colvo_torch.evaluation.raster import rgb
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import export_npz
from colvo_torch.scripts import longvideo
from test_torch_port_ablate import H, W, reference, small

torch.set_num_threads(2)

N_FRAMES = 24
ARMS = (("clean", 0.0), ("expjit", 0.35))


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """Both arms through the reference's and the port's ``run_arm``: the
    records, and the frames the reference rendered (kept from its cache
    write, which is not made)."""
    tmp = tmp_path_factory.mktemp("longvideo")
    model = ColVOModel(small()().model)
    model.reset_parameters(torch.Generator().manual_seed(0))
    weights = export_npz(model.state_dict(), str(tmp / "weights.npz"))
    ref = reference("longvideo")
    exists, ref_frames = os.path.exists, {}

    def cache(path):
        return str(path).startswith("/tmp/longvideo_")

    def savez(path, **kw):
        assert cache(path)
        ref_frames[os.path.basename(path)] = kw["frames"]

    out = {}
    for arm, jitter in ARMS:
        for name in ("ref", "port"):
            (tmp / name).mkdir(exist_ok=True)
        with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
                mock.patch.object(os.path, "exists", lambda p: False if cache(p) else exists(p)), \
                mock.patch.object(np, "savez", savez):
            want = ref.run_arm(N_FRAMES, weights, str(tmp / "ref"), arm, jitter)
        with mock.patch.object(longvideo, "ColvoConfig", small()), \
                mock.patch.object(tempfile, "tempdir", str(tmp)):
            got = longvideo.run_arm(N_FRAMES, weights, str(tmp / "port"), arm, jitter, "cpu")
        out[arm] = (got, want)
    return tmp, out, ref_frames, ref


@pytest.mark.parametrize("arm", [a for a, _ in ARMS])
def test_run_arm_matches_the_reference(arms, arm):
    """Each arm streams the reference's frames (bit for bit, the exposure
    gain drawn alike) and its drift curves, renorm every 50 frames and
    never, agree with the reference's to 1e-3 relative at their rounding."""
    tmp, out, ref_frames, _ = arms
    got, want = out[arm]
    jitter = dict(ARMS)[arm]
    name = f"longvideo_{N_FRAMES}_{H}x{W}_j{jitter}.npz"
    with np.load(tmp / name) as cached:
        assert np.array_equal(cached["frames"], ref_frames[name])
    assert set(want) <= set(got)
    for k in ("arm", "exp_jitter", "n_frames", "weights"):
        assert got[k] == want[k], k
    assert list(got["curves"]) == list(want["curves"]) == ["renorm50", "renorm0"]
    for curve in want["curves"]:
        for g, w in zip(got["curves"][curve], want["curves"][curve], strict=True):
            assert list(g) == list(w) and g["frames"] == w["frames"] == N_FRAMES
            for k in list(w)[1:]:
                assert g[k] == pytest.approx(w[k], rel=1e-3, abs=1e-6), (curve, k, g[k], w[k])
    assert got["device"] == "cpu" and got["device_peak_mb"] is None
    assert got["rss_mb_min"] <= got["rss_mb_max"] and got["fps"] > 0
    assert json.load(open(longvideo._arm_path(str(tmp / "port"), arm))) == got


def test_render_report_matches_the_reference(arms, tmp_path):
    """On the same arm records, the port's ``LONGVIDEO.md`` is the
    reference's but for the device its arms ran on; its figure has the
    reference's pixel size, and each arm's line of each panel passes
    through the pixels its data maps to, in its colour."""
    tmp, _, _, ref = arms
    for name in ("ref", "port"):
        shutil.copytree(tmp / "port", tmp_path / name,
                        ignore=shutil.ignore_patterns("*.md", "*.png"))
    ref.render_report(str(tmp_path / "ref"))
    longvideo.render_report(str(tmp_path / "port"))

    got = (tmp_path / "port" / "LONGVIDEO.md").read_text()
    want = (tmp_path / "ref" / "LONGVIDEO.md").read_text()
    assert "ONE TPU v5 lite chip (uint8 wire)" in want
    assert got == want.replace("ONE TPU v5 lite chip (uint8 wire)", "ONE cpu (uint8 wire)")

    img = read_png(str(tmp_path / "port" / "longvideo_drift.png"))
    assert img.shape == read_png(str(tmp_path / "ref" / "longvideo_drift.png")).shape == (
        374, 990, 3)
    recs = longvideo.load_arms(str(tmp_path / "port"))
    assert [r["arm"] for r in recs] == ["clean", "expjit"]
    fig = longvideo.drift_figure(recs)
    img = img.astype(np.float32) / 255
    for ax, key in zip(fig.axes, ("ate", "rpe_rot_deg")):
        for n, rec in enumerate(recs):
            rows = rec["curves"]["renorm50"]
            xy = ax.to_pixel([r["frames"] for r in rows], [r[key] for r in rows])
            color = rgb(ax.lines[n][4])
            for x, y in np.rint(xy).astype(int):
                assert np.abs(img[y, x] - color).max() < 0.1, (key, rec["arm"], x, y, img[y, x])


def test_main_writes_both_arms_and_the_report(arms, tmp_path):
    """``main`` runs an arm and redraws the report from every arm's JSON
    under ``out_dir``; the expjit arm's gain defaults to 0.35."""
    tmp, _, _, _ = arms
    with mock.patch.object(longvideo, "ColvoConfig", small()), \
            mock.patch.object(tempfile, "tempdir", str(tmp)):
        clean = longvideo.main(N_FRAMES, str(tmp / "weights.npz"), str(tmp_path), "clean",
                               device="cpu")
        jit = longvideo.main(N_FRAMES, str(tmp / "weights.npz"), str(tmp_path), "expjit",
                             device="cpu")
    assert (clean["exp_jitter"], jit["exp_jitter"]) == (0.0, 0.35)
    assert sorted(os.listdir(tmp_path)) == ["LONGVIDEO.md", "longvideo.json",
                                            "longvideo_drift.png", "longvideo_expjit.json"]
    assert (tmp_path / "LONGVIDEO.md").read_text().count(" arm (24 frames") == 2
