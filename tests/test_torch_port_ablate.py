"""The ablation workflow on colvo_torch against the reference's scripts
(``scripts/ablate.py`` and its queues ``gauge_validate``,
``gauge2_requeue`` and ``basin_levers``), driven in process on the CPU.

The reference trains from its own Flax init, so a cell's numbers cannot
equal the port's; what is held is each function: the queues' cell lists,
the config and corpus each cell hands to training, the record a cell
writes (the reference evaluating the port's exported weights), its resume
rules, and ``aggregate``'s text, byte for byte."""

import contextlib
import importlib.util
import json
import os
import runpy
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import colvo.config
import colvo.data
import colvo.pipelines  # noqa: F401  (its names bound before a test patches colvo.data)
import colvo.runtime
from colvo_torch.config import ColvoConfig
from colvo_torch.runtime import load_npz
from colvo_torch.scripts import ablate, basin_levers, gauge2_requeue, gauge_validate

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96
N_SEQUENCES, N_FRAMES = 2, 6  # the cut corpus of the end-to-end cell: 8 snippets
STEPS = 2
# One unit in the record's last place (4 digits): the two packages' float
# paths may round a value to neighbouring units.
RECORD_ABS = 1e-4



@contextlib.contextmanager
def no_tensorboard():
    """TensorBoard's import loads TensorFlow (and JAX with it) for ~20 s;
    the writer takes its absence as the reference's does. Only this key of
    ``sys.modules`` is put back: restoring the whole dict would drop the
    modules that training imports, and importing them again registers
    torch's operator libraries twice."""
    key = "torch.utils.tensorboard"
    missing = object()
    saved = sys.modules.get(key, missing)
    sys.modules[key] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules[key]
        else:
            sys.modules[key] = saved


def reference(name: str):
    """``scripts/<name>.py`` imported by path; the queues import the
    reference's ``ablate`` as a top-level module, which is dropped again
    with the path entries and environment variables the scripts set."""
    saved_path = list(sys.path)
    with mock.patch.dict(os.environ):
        spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    sys.path[:] = saved_path
    sys.modules.pop("ablate", None)
    return mod


def small(cls=ColvoConfig):
    def make():
        cfg = cls()
        cfg.model.dtype = "float32"
        cfg.data.height, cfg.data.width, cfg.data.batch_size = H, W, 2
        return cfg
    return make


def record_reference(mod, argv, env=None):
    calls = []
    with mock.patch.object(mod, "run_cell", lambda **kw: calls.append(kw)), \
            mock.patch.object(mod, "aggregate", lambda *a: None), \
            mock.patch.object(sys, "argv", argv), mock.patch.dict(os.environ, env or {}):
        mod.main()
    return calls


def record_port(main, *args, **kwargs):
    calls = []

    def run_cell(device, **kw):
        assert device == "cpu"
        calls.append(kw)

    with mock.patch.object(ablate, "run_cell", run_cell), \
            mock.patch.object(ablate, "aggregate", lambda *a: None):
        main(*args, device="cpu", **kwargs)
    return calls


@pytest.fixture(scope="module")
def queues(tmp_path_factory):
    """Each queue's cells, the reference's and the port's, at default
    arguments and (basin levers) at chosen seeds and levers."""
    tmp = tmp_path_factory.mktemp("queues")
    root = str(tmp / "r")
    out = {}
    out["ablate"] = (record_reference(reference("ablate"), ["ablate.py", "4000", root]),
                     record_port(ablate.main, 4000, root))
    out["gauge_validate"] = (
        record_reference(reference("gauge_validate"), ["gauge_validate.py", "4000", root]),
        record_port(gauge_validate.main, 4000, root))
    out["gauge2_requeue"] = (
        record_reference(reference("gauge2_requeue"), ["gauge2_requeue.py", "4000", root]),
        record_port(gauge2_requeue.main, 4000, root))
    levers = reference("basin_levers")
    out["basin_levers"] = (record_reference(levers, ["basin_levers.py", "4000", root]),
                           record_port(basin_levers.main, 4000, root))
    out["basin_levers, seeds and levers"] = (
        record_reference(levers, ["basin_levers.py", "4000", root, "7", "1234"],
                         {"COLVO_LEVERS": "both,warmup"}),
        record_port(basin_levers.main, 4000, root, seeds=[7, 1234], levers=["both", "warmup"]))
    return out


@pytest.mark.parametrize("queue", ["ablate", "gauge_validate", "gauge2_requeue", "basin_levers",
                                   "basin_levers, seeds and levers"])
def test_queue_cells_equal_the_reference(queues, queue):
    """Every queue runs the reference's cells, entry for entry, in order."""
    want, got = queues[queue]
    assert len(want) == {"ablate": 27, "gauge_validate": 15, "gauge2_requeue": 16}.get(
        queue, 6 if queue == "basin_levers" else 4)
    assert got == want


def test_ablate_main_takes_the_first_cells(tmp_path):
    """``--cells N`` runs the first N cells of the priority order."""
    got = record_port(ablate.main, 4000, str(tmp_path), n_cells=4)
    assert got == [dict(c, steps=4000, out_root=str(tmp_path)) for c in ablate.cells()[:4]]
    assert [c.get("name", "dcdp1_lcc1") for c in got] == [
        "dcdp1_lcc1", "expjit_dcdp1_lcc1", "expjit_dcdp1_lcc0", "expjit_dcdp1_lccG"]


class _Stop(Exception):
    pass


def _fake_render(calls):
    def render(**kw):
        calls.append(kw)
        return types.SimpleNamespace(frames=np.zeros((kw["n_frames"], 2, 2, 3), np.float32),
                                     k=np.eye(3, dtype=np.float32))
    return render


def _fake_train(calls):
    def train(cfg, ds, **kw):
        kw.pop("device", None)
        # the port's config without its port-only knobs (config.PORT_ONLY)
        shared = cfg.shared_dict() if hasattr(cfg, "shared_dict") else cfg.to_dict()
        calls.append((shared, len(ds), ds.frame_offsets, kw))
        raise _Stop
    return train


def _distinct_cells(queues):
    seen, cells = set(), []
    for want, _ in queues.values():
        for c in want:
            key = json.dumps(dict(c, steps=None, out_root=None), sort_keys=True)
            if key not in seen:
                seen.add(key)
                cells.append({k: v for k, v in c.items() if k not in ("steps", "out_root")})
    return cells


def test_each_cell_hands_training_the_reference_config(queues, tmp_path):
    """For every distinct cell of the four queues, the config, corpus and
    arguments the port's ``run_cell`` hands to training equal the
    reference's, knob for knob, and so do the corpus's render calls."""
    ref = reference("ablate")
    cells = _distinct_cells(queues)
    assert len(cells) >= 20
    root = str(tmp_path)
    for cell in cells:
        r_render, r_train, p_render, p_train = [], [], [], []
        with mock.patch.object(colvo.data, "render_sequence", _fake_render(r_render)), \
                mock.patch.object(colvo.runtime, "train", _fake_train(r_train)), \
                pytest.raises(_Stop):
            ref.run_cell(steps=4000, out_root=root, **cell)
        with mock.patch.object(ablate, "render_sequence", _fake_render(p_render)), \
                mock.patch.object(ablate, "train_loop", _fake_train(p_train)), \
                pytest.raises(_Stop):
            ablate.run_cell(steps=4000, out_root=root, device="cpu", **cell)
        assert p_train == r_train, cell
        assert p_render == r_render and len(p_render) == 8, cell
        assert not os.listdir(root), "nothing is written before training"


@pytest.fixture(scope="module")
def cell_run(tmp_path_factory):
    """The port's ``run_cell`` end to end: 2 steps on the cut corpus at
    64×96, export, the held-out evaluation."""
    tmp = tmp_path_factory.mktemp("cell")
    root = tmp / "port"
    with mock.patch.object(ablate, "ColvoConfig", small()), \
            mock.patch.object(ablate, "N_SEQUENCES", N_SEQUENCES), \
            mock.patch.object(ablate, "N_FRAMES", N_FRAMES), \
            no_tensorboard():
        rec = ablate.run_cell(True, True, STEPS, str(root), exp_jitter=0.35, seed=7,
                              name="expjit_dcdp1_lcc1", device="cpu")
    return tmp, root, rec


def test_run_cell_writes_the_cell(cell_run):
    """The cell's directory (``<name>_s<seed>``) holds the training log, its
    one checkpoint, the weights, the evaluation and the record."""
    _, root, rec = cell_run
    cell = root / "expjit_dcdp1_lcc1_s7"
    rows = [json.loads(line) for line in open(cell / "train" / "metrics.jsonl")]
    assert [r["step"] for r in rows if "loss/total" in r] == [STEPS]
    assert os.listdir(cell / "ckpt") == [str(STEPS)]
    for name in ("qualitative_depth.png", "trajectory_predictions.png", "metrics.json"):
        assert (cell / "eval" / name).is_file(), name
    assert json.load(open(cell / "result.json")) == rec
    assert rec["cell"] == "expjit_dcdp1_lcc1" and rec["seed"] == 7 and rec["steps"] == STEPS
    assert isinstance(rec["train_s"], int) and rec["train_s"] >= 0
    assert all(np.isfinite(v) for k, v in rec.items() if isinstance(v, float))
    load_npz(str(cell / "weights.npz"), small()().model)


def test_run_cell_record_equals_the_reference_on_the_port_weights(cell_run):
    """The reference's ``run_cell``, its training replaced by the port's
    exported weights (read by ``colvo``'s own loader), writes a record with
    the port's keys in the port's order, rounded alike, and the same
    numbers to one unit in the last place."""
    tmp, root, got = cell_run
    weights = root / "expjit_dcdp1_lcc1_s7" / "weights.npz"
    ref = reference("ablate")

    def export(params, path):
        os.link(weights, path)
        return path

    with mock.patch.object(colvo.config, "ColvoConfig", small(colvo.config.ColvoConfig)), \
            mock.patch.object(colvo.runtime, "train",
                              lambda *a, **k: (None, types.SimpleNamespace(params={}))), \
            mock.patch.object(colvo.runtime, "export_params", export):
        os.makedirs(tmp / "ref" / "expjit_dcdp1_lcc1_s7")
        want = ref.run_cell(True, True, STEPS, str(tmp / "ref"), exp_jitter=0.35, seed=7,
                            name="expjit_dcdp1_lcc1")
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "train_s":
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-3, abs=RECORD_ABS), (k, got[k], v)
            assert round(got[k], 4) == got[k], k
        else:
            assert got[k] == v, k


def test_run_cell_resumes(cell_run):
    """A cell with a record returns it without training; one with weights
    but no record is evaluated again, with ``train_s`` = -1."""
    _, root, rec = cell_run

    def no_training(*a, **k):
        raise AssertionError("a finished cell trains again")

    kw = dict(exp_jitter=0.35, seed=7, name="expjit_dcdp1_lcc1", device="cpu")
    with mock.patch.object(ablate, "ColvoConfig", small()), \
            mock.patch.object(ablate, "train_loop", no_training), \
            mock.patch.object(ablate, "corpus", no_training):
        assert ablate.run_cell(True, True, STEPS, str(root), **kw) == rec
        os.remove(root / "expjit_dcdp1_lcc1_s7" / "result.json")
        again = ablate.run_cell(True, True, STEPS, str(root), **kw)
    assert again == dict(rec, train_s=-1)
    assert json.load(open(root / "expjit_dcdp1_lcc1_s7" / "result.json")) == again


def _write_cells(root: Path, rows) -> None:
    for r in rows:
        d = root / (r["cell"] if r["seed"] == 42 else f"{r['cell']}_s{r['seed']}")
        d.mkdir(parents=True)
        (d / "result.json").write_text(json.dumps(r))


def test_aggregate_writes_the_reference_tables(tmp_path):
    """On the reference's 27 recorded cell-seeds (``docs/ablation_results.jsonl``,
    read only), both packages write the same ``ABLATION.md`` and
    ``ablation.jsonl``, byte for byte; diverged seeds are flagged."""
    rows = [json.loads(line) for line in open(ROOT / "docs" / "ablation_results.jsonl")]
    assert len(rows) == 27
    for name in ("ref", "port"):
        _write_cells(tmp_path / name, rows)
    reference("ablate").aggregate(str(tmp_path / "ref"), 4000)
    ablate.aggregate(str(tmp_path / "port"), 4000)
    for name in ("ABLATION.md", "ablation.jsonl"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    table = (tmp_path / "port" / "ABLATION.md").read_text()
    assert "⚠" in table and len(table.splitlines()) == 6 + len({r["cell"] for r in rows})
    ablate.aggregate(str(tmp_path / "empty"), 4000)  # no cell: nothing written
    assert not (tmp_path / "empty").exists()


@pytest.mark.parametrize("module,argv", [
    ("ablate", ["3"]), ("gauge_validate", ["3"]), ("gauge2_requeue", ["3"]),
    ("basin_levers", ["3"]), ("figures", []), ("scale_decoupling", []), ("gauge_probe", []),
    ("longvideo", ["24"]), ("drift_audit", ["40"]), ("expjit_analysis", []),
    ("expjit_mechanism", []),
])
def test_scripts_run_on_the_card_by_default(module, argv, tmp_path):
    """``python -m colvo_torch.scripts.<module>`` runs on ``cuda`` unless
    ``--device cpu`` is given: without a card it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("the default device exists here")
    out = tmp_path / "out"
    args = argv + ([str(out)] if module in ("ablate", "gauge_validate", "gauge2_requeue",
                                            "basin_levers") else
                   [str(tmp_path / "w.npz"), str(out)]
                   if module in ("longvideo", "drift_audit", "expjit_mechanism") else
                   [str(tmp_path), str(out)] if module in ("figures", "expjit_analysis") else
                   [str(tmp_path)])
    name = f"colvo_torch.scripts.{module}"
    imported = sys.modules.pop(name, None)  # run afresh as __main__, as ``python -m`` does
    try:
        with mock.patch.object(sys, "argv", [name] + args), \
                pytest.raises(RuntimeError, match="device='cpu'"):
            runpy.run_module(name, run_name="__main__")
    finally:
        if imported is not None:
            sys.modules[name] = imported
    assert not out.exists()
