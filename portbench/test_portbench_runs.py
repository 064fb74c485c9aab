"""Every cell's driver end to end on the CPU at toy sizes, without the look
for a card: it reports no device metric, the float8 control put in the
program's place fails the cell's limits, and each fault the cell can have,
planted under the timed path, makes ``correct`` come out false. A card
test runs the benchmark's command itself."""

import importlib
import json
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.testing import toy_run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_toy_run_reports_no_device_metric_and_the_control_fails(cell):
    train = cell.startswith("train")
    r = toy_run(cell, trace=True, readings=("control", "half") if train else ("control",))
    assert r["metrics"] == {} and r["device"]["platform"] == "cpu"
    assert "busy_s" not in r["device"] and "breakdown" not in r
    assert r["attempted"] > 0 and list(r)[-1] == "checks"
    assert set(r["checks"]) == set(harness.load_cell(cell)[3]["limits"])
    limits = harness.load_cell(cell)[3]
    for reading in r["readings"]:
        correct, _ = harness.judge(r["readings"][reading], limits)
        assert not correct, (cell, reading, r["readings"][reading])


def _unchanged(real):
    """A step that returns its state unchanged: weights and Adam's state put back."""
    def update(state, *args, **kwargs):
        params = [p.detach().clone() for p in state.model.parameters()]
        opt = {id(v): (v, v.clone()) for st in state.optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor)}
        out = real(state, *args, **kwargs)
        with torch.no_grad():
            for p, saved in zip(state.model.parameters(), params):
                p.copy_(saved)
            for v, saved in opt.values():
                v.copy_(saved)
        return out
    return update


def _half(real):
    """Half of the batch left out, the loss's means taken over the rest."""
    def loss_fn(model, batch, *args, **kwargs):
        n = batch["frames"].shape[0] // 2
        return real(model, {k: (v[:n] if k != "k" else v) for k, v in batch.items()},
                    *args, **kwargs)
    return loss_fn


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("train")])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_training_faults_are_not_correct(cell, fault):
    train_step = importlib.import_module("colvo_torch.runtime.train_step")
    if fault == "unchanged":
        patch = mock.patch.object(train_step, "_update", _unchanged(train_step._update))
    else:
        patch = mock.patch.object(train_step, "loss_fn", _half(train_step.loss_fn))
    with patch:
        r = toy_run(cell)
    assert r["correct"] is False, r["checks"]


def _altered_pairs(real):
    """Answers altered where they are produced: the first depth map mirrored,
    the rotation's sign flipped."""
    def body(runner, a, b):
        da, db, aa, tr = real(runner, a, b)
        return da.flip(-1), db, -aa, tr
    return body


def _altered_wire(real):
    def pack(sdisp, pose6, wire_dtype):
        sign = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], device=pose6.device)
        return real(sdisp.flip(-1), pose6 * sign, wire_dtype)
    return pack


@pytest.mark.parametrize("cell", [c for c in CELLS if not c.startswith("train")])
def test_an_altered_answer_is_not_correct(cell):
    if cell.startswith("vo"):
        from colvo_torch.vo import stream

        patch = mock.patch.object(stream, "_pack", _altered_wire(stream._pack))
    else:
        from colvo_torch.runtime import infer

        patch = mock.patch.object(infer, "_coupled_body", _altered_pairs(infer._coupled_body))
    with patch:
        r = toy_run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert np.isfinite([m["value"] for m in r["metrics"].values()]).all()
