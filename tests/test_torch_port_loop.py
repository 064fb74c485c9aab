"""colvo_torch's training entry point (cli train → pipelines.train →
runtime/loop.py::train) against colvo's behaviour: restart, the
dispatch-side NaN stop, the LR schedule's epoch length, the loader and
mesh it refuses, the prefetcher, the CLI's train and export, and the
eval hook against the reference's on the same weights, on the CPU."""

import json
import math
import os
import threading
import types
from pathlib import Path
from unittest import mock

import flax
import numpy as np
import pytest
import torch

import colvo_torch.runtime.loop as port_loop
from colvo.config import ColvoConfig as JaxConfig
from colvo.data import prefetch_to_device as jax_prefetch
from colvo.models import ColVOModel as JaxModel
from colvo.pipelines import make_training_eval_hook as jax_eval_hook
from colvo.runtime.checkpoint import load_params as jax_load_params
from colvo.runtime.infer import InferenceRunner as JaxRunner
from colvo_torch import cli
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, prefetch_to_device, render_sequence
from colvo_torch.models import ColVOModel
from colvo_torch.pipelines import make_training_eval_hook
from colvo_torch.runtime import InferenceRunner, MetricsWriter, flax_params, load_npz
from colvo_torch.runtime import train as train_loop

torch.set_num_threads(2)

H, W = 64, 96


def tiny_config(tmp_path):
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width = H, W
    cfg.data.frame_offsets = (1,)
    cfg.data.batch_size = 2
    cfg.data.augment = False
    cfg.train.lr = 3e-4
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    return cfg


def _dataset(n_frames=8, poison=None):
    seq = render_sequence(n_frames=n_frames, height=H, width=W, seed=3)
    frames = seq.frames.copy()
    if poison is not None:
        frames[poison] = np.nan
    return SnippetDataset([frames], [seq.k], (1,))


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_basin_detect_and_restart(tmp_path):
    """The reference's test_train_smoke.py::test_basin_detect_and_restart:
    the restart fires once at the check step, reinits from seed + 1000,
    resets the step clock and the checkpoints (attempt 0 saved step 2), and
    the last attempt runs to max_steps and saves step 6 after the reset.
    The weights are not compared: the port's init draws from
    torch.Generator."""
    cfg = tiny_config(tmp_path)
    cfg.train.log_every = 2
    cfg.train.ckpt_every_steps = 2
    cfg.train.restart_metric = "loss/total"
    cfg.train.restart_threshold = 1e-9  # always trips at the check step
    cfg.train.restart_check_step = 3
    cfg.train.restart_max = 1
    seeds = []
    real_init = port_loop.init_state

    def init_state(cfg_, seed=None, **kw):
        seeds.append(seed)
        return real_init(cfg_, seed=seed, **kw)

    saved_before_reset = []
    real_reset = port_loop.CheckpointManager.reset

    def reset(self):
        self.wait()
        saved_before_reset.extend(sorted(os.listdir(cfg.train.ckpt_dir)))
        real_reset(self)

    with mock.patch.object(port_loop, "init_state", init_state), \
            mock.patch.object(port_loop.CheckpointManager, "reset", reset):
        _, state = train_loop(cfg, _dataset(), log_dir=str(tmp_path / "log"), max_steps=6,
                              device="cpu")
    rows = _rows(tmp_path / "log")
    restarts = [r for r in rows if "restart/attempt" in r]
    assert len(restarts) == 1, restarts
    assert restarts[0]["step"] == 3
    assert restarts[0]["restart/new_seed"] == cfg.train.seed + 1000
    assert restarts[0]["restart/metric_value"] > 0
    assert seeds == [None, cfg.train.seed + 1000]
    assert [r["step"] for r in rows if "loss/total" in r] == [2, 2, 4, 6]
    assert state.step == 6
    assert saved_before_reset == ["2"]
    saved = sorted(int(d) for d in os.listdir(cfg.train.ckpt_dir) if d.isdigit())
    assert saved == [2, 4, 6]


def test_dispatch_side_nan_stop(tmp_path):
    """The reference's test_dispatch_side_nan_stop: a poisoned frame makes
    the loss non-finite; the loop retires the loss from one log window back
    and raises before it has dispatched more than two windows past it."""
    cfg = tiny_config(tmp_path)
    cfg.train.log_every = 1
    cfg.train.dispatch_ahead_windows = 1
    calls = []
    real_make = port_loop.make_step_fn

    def make_step_fn(state, cfg_):
        step_fn = real_make(state, cfg_)

        def counted(state, batch):
            calls.append(state.step + 1)
            return step_fn(state, batch)
        return counted

    with mock.patch.object(port_loop, "make_step_fn", make_step_fn), \
            pytest.raises(RuntimeError, match="non-finite") as info:
        train_loop(cfg, _dataset(poison=2), log_dir=str(tmp_path / "log"), max_steps=30,
                   device="cpu")
    bad = int(str(info.value).rsplit(" ", 1)[-1])
    assert calls[-1] - bad <= cfg.train.dispatch_ahead_windows + 1, (calls, bad)
    assert calls[-1] < 30


def test_steps_per_epoch_reaches_the_lr_schedule(tmp_path):
    """steps_per_epoch = len(dataset) // batch_size goes into the state, so
    the LR decays after train.lr_decay_epochs of this dataset's epochs (at
    step 2 here), not of the port's default 1000-step epoch. The step takes
    its learning rate from the device step counter, in float32
    (``learning_rate_t``), as on the card."""
    cfg = tiny_config(tmp_path)
    cfg.train.lr_decay_epochs = 1
    cfg.train.log_every = 10
    lrs = []
    real_make = port_loop.make_step_fn

    def make_step_fn(state, cfg_):
        step_fn = real_make(state, cfg_)

        def recorded(state, batch):
            out = step_fn(state, batch)
            lrs.append(state.optimizer.param_groups[0]["lr"])
            return out
        return recorded

    with mock.patch.object(port_loop, "make_step_fn", make_step_fn):
        _, state = train_loop(cfg, _dataset(n_frames=6), log_dir=str(tmp_path / "log"),
                              max_steps=3, device="cpu")
    assert state.steps_per_epoch == 2
    assert lrs == [float(np.float32(3e-4)), float(np.float32(3e-4)),
                   float(np.float32(3e-4 * 0.1))]


def test_profiler_window_and_eval_hook_in_the_loop(tmp_path):
    """profile_steps="1:2" writes a Chrome trace of step 1; the hook
    from eval_hook_factory(cfg, model) runs at every epoch's end (2-step
    epochs) with the step's state and the logger's writer, and its scalars
    land in metrics.jsonl at those steps."""
    cfg = tiny_config(tmp_path)
    cfg.train.profile_steps = "1:2"
    cfg.train.log_every = 10
    calls = []

    def factory(cfg_, model):
        assert cfg_ is cfg and isinstance(model, torch.nn.Module)

        def hook(step, state, writer):
            calls.append((step, state.step, writer))
            return {"eval/probe": float(step)}
        return hook

    log_dir = str(tmp_path / "log")
    train_loop(cfg, _dataset(n_frames=6), log_dir=log_dir, max_steps=4,
               eval_hook_factory=factory, device="cpu")
    assert [(s, t) for s, t, _ in calls] == [(2, 2), (4, 4)]
    assert all(isinstance(w, MetricsWriter) and w.log_dir == log_dir for _, _, w in calls)
    assert [(r["step"], r["eval/probe"]) for r in _rows(log_dir) if "eval/probe" in r] == [
        (2, 2.0), (4, 4.0)]
    with open(os.path.join(log_dir, "trace_steps_1_2.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


def test_debug_nans_runs_the_steps_under_anomaly_mode(tmp_path):
    cfg = tiny_config(tmp_path)
    cfg.train.debug_nans = True
    seen = []
    real_step = port_loop.train_step

    def train_step(state, batch, cfg_):
        seen.append(torch.is_anomaly_enabled())
        return real_step(state, batch, cfg_)

    with mock.patch.object(port_loop, "train_step", train_step):
        train_loop(cfg, _dataset(), log_dir=str(tmp_path / "log"), max_steps=1, device="cpu")
    assert seen == [True] and not torch.is_anomaly_enabled()


def test_max_bad_steps_aborts(tmp_path):
    """With the dispatch-ahead drain out of reach, the logger's count of
    consecutive non-finite losses stops the loop (loop.py:188-191)."""
    cfg = tiny_config(tmp_path)
    cfg.train.log_every = 1
    cfg.train.dispatch_ahead_windows = 1000
    cfg.train.max_bad_steps = 2
    with pytest.raises(RuntimeError, match="2 consecutive non-finite losses"):
        train_loop(cfg, _dataset(poison=2), log_dir=str(tmp_path / "log"), max_steps=40,
                   device="cpu")


def test_restart_metric_must_be_a_step_metric(tmp_path):
    cfg = tiny_config(tmp_path)
    cfg.train.restart_metric = "loss/nope"
    cfg.train.restart_threshold = 1.0
    cfg.train.restart_check_step = 1
    with pytest.raises(ValueError, match="loss/nope"):
        train_loop(cfg, _dataset(), log_dir=str(tmp_path / "log"), max_steps=3, device="cpu")


@pytest.mark.parametrize("knob,value,error", [
    ("data.loader", "torch", ValueError),
    ("mesh.data_parallel", 2, ValueError),
])
def test_unported_loaders_and_meshes_raise(tmp_path, knob, value, error):
    """An unknown loader, and a mesh of more ranks than the process group
    has (none here: one process), are refused before a step."""
    cfg = tiny_config(tmp_path)
    section, leaf = knob.split(".")
    setattr(getattr(cfg, section), leaf, value)
    with pytest.raises(error, match="loader" if section == "data" else "WORLD_SIZE=1"):
        train_loop(cfg, _dataset(), log_dir=str(tmp_path / "log"), max_steps=1, device="cpu")


def test_prefetcher_keeps_order_and_ends_with_the_stream():
    """The reference's test_data.py::test_prefetch_preserves_order, on the
    same batches through both prefetchers; the port's are float32 tensors."""
    cfg = tiny_config(Path("unused")).data
    cfg.augment = True
    ds = _dataset(n_frames=10)
    direct = list(batch_iterator(ds, cfg, seed=0, epochs=2))
    port = list(prefetch_to_device(batch_iterator(ds, cfg, seed=0, epochs=2), device="cpu"))
    ref = list(jax_prefetch(batch_iterator(ds, cfg, seed=0, epochs=2)))
    assert len(direct) == len(port) == len(ref) == 8
    for a, b, c in zip(direct, port, ref):
        assert set(b) == {"frames", "frames_clean", "k"}
        for key in b:
            assert b[key].dtype == torch.float32
            np.testing.assert_array_equal(b[key].numpy(), a[key])
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(c[key]))


def test_prefetcher_raises_the_producers_error_and_stops_on_close():
    def failing():
        yield {"frames": np.zeros((1, 2), np.float32)}
        raise OSError("disk gone")

    stream = prefetch_to_device(failing(), device="cpu")
    assert next(stream)["frames"].shape == (1, 2)
    with pytest.raises(RuntimeError, match="producer failed") as info:
        next(stream)
    assert isinstance(info.value.__cause__, OSError)

    def endless():
        while True:
            yield {"x": np.ones(3)}

    before = threading.active_count()
    stream = prefetch_to_device(endless(), size=2, device="cpu")
    next(stream)
    stream.close()
    assert threading.active_count() == before


def _cli_args(tmp_path):
    return ["--log-dir", str(tmp_path / "log"), f"--train.ckpt_dir={tmp_path / 'ckpt'}",
            f"--data.height={H}", f"--data.width={W}", "--data.batch_size=2",
            "--model.dtype=float32", "--model.n_scales=2", "--data.frame_offsets=[1]",
            "--data.augment=false", "--train.log_every=1", "--train.ckpt_every_steps=2"]


def test_cli_requires_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--max-steps", "1"] + _cli_args(tmp_path))
    assert not os.path.exists(tmp_path / "log")


def test_cli_train_then_export_serves_in_the_reference(tmp_path):
    """``train --device cpu`` for 2 steps, then ``export``: the .npz loads
    through colvo's load_params, and colvo's InferenceRunner gives the
    port's depth on it to 1e-4 relative."""
    assert cli.main(["train", "--device", "cpu", "--max-steps", "2"] + _cli_args(tmp_path)) == 0
    rows = _rows(tmp_path / "log")
    assert [r["step"] for r in rows if "loss/total" in r] == [1, 2]
    assert all(math.isfinite(r["loss/total"]) for r in rows if "loss/total" in r)
    assert "wall_steps_per_sec" in rows[-1]
    out = str(tmp_path / "weights")
    assert cli.main(["export", str(tmp_path / "ckpt"), out, "--model.n_scales=2"]) == 0
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for c in (jcfg, tcfg):
        c.model.dtype, c.model.n_scales = "float32", 2
        c.data.height, c.data.width = H, W
    frames = np.random.default_rng(4).random((2, H, W, 3), dtype=np.float32)
    want, _ = JaxRunner(jcfg, jax_load_params(out)).infer_depth(frames)
    port = InferenceRunner(tcfg, load_npz(out, tcfg.model), device="cpu")
    got, _ = port.infer_depth(frames)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=0)
    with pytest.raises(KeyError):  # the checkpoint does not fit a 4-scale model
        cli.main(["export", str(tmp_path / "ckpt"), out])


def test_eval_hook_matches_the_reference(tmp_path):
    """Both hooks at step 0 on the same weights: every eval/* scalar within
    1e-3 relative (ATE through each package's pose chain); the port's three
    panels decode to (H, W, 3)."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for c in (jcfg, tcfg):
        c.model.dtype = "float32"
        c.data.height, c.data.width = H, W
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in ColVOModel(tcfg.model).state_dict().items():
        if v.ndim == 4:
            a = rng.normal(0, 1 / math.sqrt(v[0].numel()), v.shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.05 * rng.normal(size=v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    flat = flax_params(sd)
    model = ColVOModel(tcfg.model)
    model.load_state_dict(sd)
    model.train()
    want = jax_eval_hook(jcfg, JaxModel(jcfg.model))(
        0, types.SimpleNamespace(params=flax.traverse_util.unflatten_dict(flat, sep="/")), None)
    got = make_training_eval_hook(tcfg, model)(0, types.SimpleNamespace(model=model), None)
    assert sorted(got) == sorted(want) and "eval/abs_rel" in got and "eval/ate" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-12), (k, got[k], want[k])
    assert model.training  # restored after the hook's eval mode

    writer = MetricsWriter(str(tmp_path), also_stdout=False)
    make_training_eval_hook(tcfg, model)(7, types.SimpleNamespace(model=model), writer)
    writer.close()
    import imageio.v2 as imageio

    for tag in ("disp", "automask", "warp_error"):
        assert imageio.imread(tmp_path / f"panels_{tag}_00000007.png").shape == (H, W, 3)
