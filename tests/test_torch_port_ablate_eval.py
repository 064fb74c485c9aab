"""The studies of the ablation's trained cells on colvo_torch against the
reference's scripts (``scripts/figures.py``, ``scale_decoupling.py`` and
``gauge_probe.py``), driven in process on the CPU at 64×96 over the same
exported weights: the predicted depths and aligned trajectories each
figure draws, the scale-decoupling rows and the gauge probe's lines agree
to 1e-3 relative at their own rounding."""

import json
import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import colvo.config
import colvo.evaluation.viz
from colvo_torch.data.png import read_png
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import export_npz
from colvo_torch.scripts import figures, gauge_probe, scale_decoupling
from test_torch_port_ablate import reference, small

torch.set_num_threads(2)

# cell -> model.dcdp_fusion: two random inits of the port's model, one an
# architecture, each exported under two cell names
CELLS = {"dcdp1_lcc1": True, "dcdp0_lcc1": False, "expjit_dcdp1_lccG": True, "dcdp0_lcc0": False}
POLYP_E = 0.2468  # dcdp1_lcc1's recorded polyp error


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``<tmp>/runs/ablate`` holding the CELLS' exported weights (random
    inits of the port's model) and one ``result.json``."""
    tmp = tmp_path_factory.mktemp("studies")
    ablate_root = tmp / "runs" / "ablate"
    for dcdp in (True, False):
        cfg = small()()
        cfg.model.dcdp_fusion = dcdp
        model = ColVOModel(cfg.model)
        model.reset_parameters(torch.Generator().manual_seed(int(dcdp)))
        first, *others = (c for c, d in CELLS.items() if d == dcdp)
        (ablate_root / first).mkdir(parents=True)
        export_npz(model.state_dict(), str(ablate_root / first / "weights.npz"))
        for cell in others:  # the same file under another name
            (ablate_root / cell).mkdir(parents=True)
            os.link(ablate_root / first / "weights.npz", ablate_root / cell / "weights.npz")
    (ablate_root / "dcdp1_lcc1" / "result.json").write_text(json.dumps({"polyp/e_mean": POLYP_E}))
    return ablate_root


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _close(got, want, places: int):
    return got == pytest.approx(want, rel=1e-3, abs=10.0 ** -places, nan_ok=True)


def test_figures_draw_what_the_reference_draws(root, tmp_path):
    """The methods present (the others skipped), frame 0's predicted depth
    a method and the aligned trajectories agree with the reference's
    (1e-3 of each array's largest value); the two figures are written."""
    drawn = {}

    def keep(name):
        def viz(*args, **kwargs):
            drawn[name] = args
        return viz

    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(colvo.evaluation.viz, "viz_depth_grid", keep("depth")), \
            mock.patch.object(colvo.evaluation.viz, "viz_trajectory", keep("traj")), \
            mock.patch.object(sys, "argv", ["figures.py", str(root), str(tmp_path / "ref")]):
        reference("figures").main()
    with mock.patch.object(figures, "ColvoConfig", small()):
        preds, trajs = figures.main(str(root), str(tmp_path / "port"), "cpu")

    want_preds, want_trajs = drawn["depth"][2], drawn["traj"][0]
    assert list(preds) == list(want_preds) == [
        "ColVO(ours)", "-DCDP", "expjit-trained LCC-global"]
    assert list(trajs) == list(want_trajs)
    for label in want_preds:
        want = np.asarray(want_preds[label])
        np.testing.assert_allclose(preds[label], want, rtol=0, atol=1e-3 * np.abs(want).max())
    for label in want_trajs:
        want = np.asarray(want_trajs[label], np.float64)
        assert trajs[label].shape == want.shape == (48, 3)
        np.testing.assert_allclose(trajs[label], want, rtol=0, atol=1e-3 * np.abs(want).max())
    # the reference's sizes at 130 dpi: 7 × 2.6 in a row (GT and three methods), 7 × 6 in
    for name, shape in (("qualitative_depth_methods.png", (1352, 910, 3)),
                        ("trajectories_methods.png", (780, 910, 3))):
        assert read_png(str(tmp_path / "port" / name)).shape == shape, name


def test_figures_need_two_methods(root, tmp_path):
    """With one trained cell the figures are not drawn."""
    solo = tmp_path / "solo"
    shutil.copytree(root / "dcdp1_lcc1", solo / "dcdp1_lcc1", copy_function=os.link)
    with mock.patch.object(figures, "ColvoConfig", small()):
        assert figures.main(str(solo), str(tmp_path / "out"), "cpu") is None
    assert os.listdir(tmp_path / "out") == []


def test_scale_decoupling_rows_equal_the_reference(root, tmp_path, capsys):
    """The runs present, their evaluation arm, s_traj, s_depth, their ratio
    and the recorded polyp error (NaN without a record) equal the
    reference's at the table's rounding; the markdown has the reference's
    lines around them."""
    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(sys, "argv", ["scale_decoupling.py", str(root),
                                            str(tmp_path / "ref.md")]):
        reference("scale_decoupling").main()
    want = _json_lines(capsys.readouterr().out)
    with mock.patch.object(scale_decoupling, "ColvoConfig", small()):
        got = scale_decoupling.main(str(root), None, "cpu")

    assert [r["run"] for r in got] == [r["run"] for r in want] == [
        "expjit_dcdp1_lccG", "dcdp0_lcc0", "dcdp1_lcc1"]
    for g, w in zip(got, want):
        assert g["eval_arm"] == w["eval_arm"]
        for key, places in (("s_traj", 4), ("s_depth", 4), ("decoupling", 3),
                            ("polyp_e_mean", 3)):
            assert _close(g[key], w[key], places), (g["run"], key, g[key], w[key])
    assert got[-1]["polyp_e_mean"] == round(POLYP_E, 3)
    md = (root / "SCALE_DECOUPLING.md").read_text().splitlines()
    ref_md = (tmp_path / "ref.md").read_text().splitlines()
    assert md[:6] == ref_md[:6] and len(md) == len(ref_md) == 6 + len(want)


@pytest.mark.parametrize("where", ["runs/ablate", "another root"])
def test_gauge_probe_lines_equal_the_reference(root, where, capsys, monkeypatch):
    """Under ``runs/ablate`` the probe reads ``RUNS`` (missing ones
    reported as skipped); under another root every cell with weights,
    named as ``run_cell`` names them. Each line's numbers equal the
    reference's at its rounding."""
    monkeypatch.chdir(root.parents[1])
    # the reference's 12 frames under runs/ablate, 6 under the other root
    arg, n = ("runs/ablate", 12) if where == "runs/ablate" else (str(root), 6)
    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(sys, "argv", ["gauge_probe.py", arg] + ([] if n == 12 else [str(n)])):
        reference("gauge_probe").main()
    want = _json_lines(capsys.readouterr().out)
    with mock.patch.object(gauge_probe, "ColvoConfig", small()):
        got = gauge_probe.main(arg, n, "cpu")

    assert [r["run"] for r in got] == [r["run"] for r in want]
    if where == "runs/ablate":
        assert len(got) == len(gauge_probe.RUNS)
        assert sum("skip" in r for r in got) == len(gauge_probe.RUNS) - 3
    else:
        assert [r["run"] for r in got] == sorted(CELLS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, v in w.items():
            if isinstance(v, float):
                places = 5 if key.endswith("depth") else 6
                assert _close(g[key], v, places), (g["run"], key, g[key], v)
            else:
                assert g[key] == v
