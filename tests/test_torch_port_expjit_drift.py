"""The README's last three studies on colvo_torch against the reference's
scripts (``scripts/drift_audit.py``, ``expjit_analysis.py`` and
``expjit_mechanism.py``), driven in process on the CPU at 64×96 in
float32 over the same exported weights (random inits of the port's
model), each reference writing under the test's temporary directory.

Tolerances:
- ``drift_audit`` (40 frames: 39 pairs, one batch of 32 and one padded):
  every statistic to 1e-3 relative; ``mean_axis``, rounded to 6 places by
  the script, also to one unit of that rounding (1e-6 absolute).
- ``expjit_analysis`` (two cells present): the rows at their 4-digit
  rounding to 1e-3 relative or 1e-4 absolute (one unit in the last
  place); the skip lines and the table's rows equal.
- ``expjit_mechanism`` (9 frames): the saturated fraction exact; H1's
  median and p90 to 1e-3 relative; the fractions of H2 (min-reprojection
  source) and H3 (automask keep) within 2e-3 absolute: the two packages'
  float32 errors differ by ~1e-5, so a few pixels at a near-tie may flip
  (one pixel is 1.6e-4 of a 64×96 frame); the clean arm's H2 is None."""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import colvo.config
import colvo.evaluation.viz
from colvo_torch.data.png import read_png
from colvo_torch.data.synthetic import render_sequence
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import export_npz
from colvo_torch.scripts import drift_audit, expjit_analysis, expjit_mechanism
from test_torch_port_ablate import H, W, reference, small

torch.set_num_threads(2)

DRIFT_FRAMES = 40
MECH_FRAMES = 9
TOL_FRACTION = 2e-3  # H2 and H3's pixel fractions, absolute
PRESENT = ("dcdp1_lcc1", "expjit_dcdp1_lccG")  # expjit_analysis's cells with weights


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Two random inits of the port's model (dcdp fusion on), exported."""
    tmp = tmp_path_factory.mktemp("weights")
    out = []
    for seed in (0, 1):
        model = ColVOModel(small()().model)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        out.append(export_npz(model.state_dict(), str(tmp / f"w{seed}.npz")))
    return out


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_drift_audit_stats_equal_the_reference(weights, tmp_path, capsys):
    ref_md, port_md = tmp_path / "ref" / "DRIFT.md", tmp_path / "port" / "DRIFT.md"
    ref_md.parent.mkdir()
    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(sys, "argv", ["drift_audit.py", str(DRIFT_FRAMES), weights[0],
                                            str(ref_md)]):
        reference("drift_audit").main()
    want = json.loads(capsys.readouterr().out)
    with mock.patch.object(drift_audit, "ColvoConfig", small()):
        got = drift_audit.main(DRIFT_FRAMES, weights[0], str(port_md), "cpu")

    assert got["n_frames"] == want["n_frames"] == DRIFT_FRAMES
    assert got["weights"] == want["weights"]
    for arm in ("forward", "symmetrized"):
        assert set(got[arm]) == set(want[arm])
        for key in ("mean_norm_deg", "norm_mean_deg", "bias_fraction"):
            assert got[arm][key] == pytest.approx(want[arm][key], rel=1e-3), (arm, key)
        np.testing.assert_allclose(got[arm]["mean_axis"], want[arm]["mean_axis"],
                                   rtol=1e-3, atol=1e-6)
        assert 0.0 <= got[arm]["bias_fraction"] <= 1.0
    # the errors are not all rounding: the GT's wobble keeps them well above 1e-4 rad
    assert np.radians(got["forward"]["norm_mean_deg"]) > 1e-4
    assert got["fwd_plus_rev_rot_deg"] == pytest.approx(want["fwd_plus_rev_rot_deg"], rel=1e-3)
    md, ref_lines = port_md.read_text().splitlines(), ref_md.read_text().splitlines()
    assert md[:9] == ref_lines[:9] and md[-1] == ref_lines[-1] == "```"
    assert json.loads("\n".join(md[9:-1])) == got


def test_drift_audit_pads_the_last_batch(weights):
    """39 pairs: one batch of 32 and one of 7 padded to 32 and trimmed, so
    every call has one shape; the padded call's rows equal those of an
    unpadded call on the same pairs."""
    calls = []

    class Runner:
        def infer_pose(self, a, b):
            calls.append(a.shape[0])
            return np.stack([np.full(6, a[i].sum() - b[i].sum()) for i in range(len(a))])

    a = np.random.default_rng(0).random((39, 2, 2, 3))
    b = a[::-1].copy()
    out = drift_audit.rel6(Runner(), a, b)
    assert calls == [32, 32] and out.shape == (39, 6)
    np.testing.assert_array_equal(out[:, 0], a.sum((1, 2, 3)) - b.sum((1, 2, 3)))


def test_expjit_analysis_rows_equal_the_reference(weights, tmp_path, capsys):
    root = tmp_path / "runs" / "ablate"
    for cell, w in zip(PRESENT, weights):
        (root / cell).mkdir(parents=True)
        os.link(w, root / cell / "weights.npz")
    drawn = {}
    real_viz = colvo.evaluation.viz.viz_depth_grid

    def keep(rgb, gt, preds, path, max_depth=1.0):
        drawn[os.path.basename(path)] = next(iter(preds.values()))
        return real_viz(rgb, gt, preds, path, max_depth=max_depth)

    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(colvo.evaluation.viz, "viz_depth_grid", keep), \
            mock.patch.object(sys, "argv", ["expjit_analysis.py", str(root),
                                            str(tmp_path / "ref")]):
        reference("expjit_analysis").main()
    ref_out = capsys.readouterr().out
    with mock.patch.object(expjit_analysis, "ColvoConfig", small()):
        got = expjit_analysis.main(str(root), str(tmp_path / "port"), "cpu")
    port_out = capsys.readouterr().out

    want = _json_lines(ref_out)
    assert [r["cell"] for r in got] == [r["cell"] for r in want] == list(PRESENT)
    for g, w in zip(got, want):
        for arm in ("clean", "expjit"):
            for key in expjit_analysis.KEYS:
                assert g[arm][key] == pytest.approx(w[arm][key], rel=1e-3, abs=1e-4), (
                    g["cell"], arm, key)
    skips = [line for line in port_out.splitlines() if line.startswith("skip ")]
    assert skips == [line for line in ref_out.splitlines() if line.startswith("skip ")]
    assert len(skips) == 2
    md = (tmp_path / "port" / "EXPJIT_DEPTH.md").read_text().splitlines()
    ref_md = (tmp_path / "ref" / "EXPJIT_DEPTH.md").read_text().splitlines()
    assert len(md) == len(ref_md)
    assert [line for line in md if not line.startswith("| d") and not line.startswith("| e")] \
        == [line for line in ref_md if not line.startswith("| d")
            and not line.startswith("| e")]
    if got == want:  # the rounded rows agree: the table's rows are the same text
        assert md == ref_md
    # frame 0's prediction each map draws, and the maps themselves
    for cell in PRESENT:
        for arm in ("clean", "expjit"):
            name = f"{cell}_{arm}.png"
            assert read_png(str(tmp_path / "port" / "maps" / name)).ndim == 3
            assert drawn[name].shape == (H, W)
    assert sorted(os.listdir(tmp_path / "port" / "maps")) == sorted(drawn)


def test_expjit_analysis_without_cells_writes_no_table(tmp_path, capsys):
    with mock.patch.object(expjit_analysis, "ColvoConfig", small()):
        assert expjit_analysis.main(str(tmp_path / "none"), str(tmp_path / "out"), "cpu") == []
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "no cells available" and len(out) == 1 + len(expjit_analysis.CELLS)
    assert not (tmp_path / "out" / "EXPJIT_DEPTH.md").exists()


def test_expjit_mechanism_equals_the_reference(weights, tmp_path, capsys):
    ref_mod = reference("expjit_mechanism")
    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(ref_mod, "N_FRAMES", MECH_FRAMES), \
            mock.patch.object(sys, "argv", ["expjit_mechanism.py", weights[1],
                                            str(tmp_path / "ref.md")]):
        ref_mod.main()
    want = {}
    for rec in _json_lines(capsys.readouterr().out):
        want.update(rec)
    with mock.patch.object(expjit_mechanism, "ColvoConfig", small()), \
            mock.patch.object(expjit_mechanism, "N_FRAMES", MECH_FRAMES):
        got = expjit_mechanism.main(weights[1], str(tmp_path / "port.md"), "cpu")

    assert list(got) == list(want) == ["clean", "jittered"]
    for arm in got:
        g, w = got[arm], want[arm]
        assert list(g) == list(w)
        assert g["sat_frac"] == w["sat_frac"]
        for key in ("ga_rel_err_median", "ga_rel_err_p90"):
            assert g[key] == pytest.approx(w[key], rel=1e-3), (arm, key)
        for key in ("sel_gain_frac_mean", "automask_keep_frac_raw_identity",
                    "automask_keep_frac_calibrated_identity"):
            if w[key] is None:
                assert g[key] is None, (arm, key)
            else:
                assert abs(g[key] - w[key]) <= TOL_FRACTION, (arm, key, g[key], w[key])
    assert got["clean"]["sel_gain_frac_mean"] is None
    assert got["jittered"]["sel_gain_frac_mean"] is not None
    md = (tmp_path / "port.md").read_text().splitlines()
    ref_md = (tmp_path / "ref.md").read_text().splitlines()
    # the header, the table's labels, the clean arm's H2 and the reading's
    # heading are the reference's text
    assert len(md) == len(ref_md) == 19
    assert md[:6] == ref_md[:6] and md[12:15] == ref_md[12:15]
    for line, ref_line in zip(md[6:12], ref_md[6:12]):
        assert line.split(" | ")[0] == ref_line.split(" | ")[0]
    assert md[9].split(" | ")[1] == ref_md[9].split(" | ")[1] == "—"
    for line, ref_line in zip(md[15:], ref_md[15:]):
        assert line.split("** — ")[0] == ref_line.split("** — ")[0]


def test_the_true_gains_are_the_renderers():
    """``true_gains`` draws what ``render_sequence`` applies: below
    saturation, a jittered frame over its clean frame is the frame's gain."""
    n, (h, w) = MECH_FRAMES, (16, 24)
    clean = render_sequence(n, h, w, seed=expjit_mechanism.SEED).frames
    jit = render_sequence(n, h, w, seed=expjit_mechanism.SEED,
                          exposure_jitter=expjit_mechanism.JITTER).frames
    gains = expjit_mechanism.true_gains(n, expjit_mechanism.JITTER)
    assert gains.shape == (n,) and np.all(np.abs(gains - 1.0) <= expjit_mechanism.JITTER)
    assert len(set(gains.tolist())) == n
    for i in range(n):
        below = (jit[i] < 1.0) & (clean[i] > 0.05)
        assert below.mean() > 0.5
        np.testing.assert_allclose(jit[i][below] / clean[i][below], gains[i], rtol=1e-6)
    np.testing.assert_array_equal(expjit_mechanism.true_gains(n, 0.0), np.ones(n))
