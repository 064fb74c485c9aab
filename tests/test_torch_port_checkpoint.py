"""colvo_torch's CheckpointManager: round trip, keep-N, the save interval,
atomic step directories, reset, and kill-and-resume through the training
loop, bitwise on the CPU (the reference's tests/test_checkpoint.py)."""

import os
import shutil

import numpy as np
import pytest
import torch

from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.runtime import CheckpointManager, TrainState
from colvo_torch.runtime import train as train_loop

torch.set_num_threads(2)


def _small_state(seed: int = 0, steps: int = 2) -> TrainState:
    """A TrainState over a two-layer stand-in model with ``steps`` Adam
    steps taken, so that the moments are not zero."""
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 2))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x = torch.randn((4, 6), generator=gen)
    for _ in range(steps):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    return TrainState(model, opt, steps, 7)


def _tensors(state: TrainState):
    """Every tensor of the model and the optimizer state, by name."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{i}/{k}": v for k, v in s.items()})
    return out


def _assert_equal_states(a, b):
    ta, tb = (_tensors(s) if isinstance(s, TrainState) else s for s in (a, b))
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k].cpu(), tb[k].cpu()), k


def test_round_trip_with_loader_state(tmp_path):
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    assert mgr.save(7, state, loader_state=b"\x00loader\xff")
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ckpt" / "7")) == ["loader.bin", "state.pt"]
    fresh = _small_state(seed=1, steps=1)
    restored, step, loader = mgr.restore(fresh, with_loader_state=True)
    assert restored is fresh and step == 7 and loader == b"\x00loader\xff"
    assert (restored.step, restored.steps_per_epoch) == (2, 7)
    _assert_equal_states(restored, state)
    assert restored.optimizer.param_groups[0]["lr"] == 1e-2
    mgr.close()


def test_keep_n_policy(tmp_path):
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    for s in (1, 2, 3):
        assert mgr.save(s, state)
    mgr.wait()
    assert mgr.latest_step() == 3
    _, step = mgr.restore(state)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=1)  # evicted by keep=2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]
    mgr.close()
    # a new manager over the directory sees what is on disk
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 3


def test_save_interval_follows_orbax(tmp_path):
    """The first save always happens; then every 4th step; never a step at
    or before the latest."""
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=10, save_interval_steps=4)
    decisions = {s: mgr.save(s, state) for s in (1, 2, 3, 4, 6, 8)}
    assert decisions == {1: True, 2: False, 3: False, 4: True, 6: False, 8: True}
    assert not mgr.save(8, state) and not mgr.save(4, state)
    mgr.close()
    assert sorted(os.listdir(tmp_path / "ckpt"), key=int) == ["1", "4", "8"]


def test_a_killed_save_leaves_no_step(tmp_path, monkeypatch):
    """A save that dies mid-write leaves only ``<step>.tmp``: the latest
    step stays the one before, the error reaches ``wait``, and the next
    manager over the directory clears the leftover."""
    state = _small_state()
    ckpt = tmp_path / "ckpt"
    mgr = CheckpointManager(str(ckpt))
    mgr.save(2, state)
    mgr.wait()

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("killed")

    monkeypatch.setattr(torch, "save", dies)
    mgr.save(3, state)
    with pytest.raises(OSError, match="killed"):
        mgr.wait()
    monkeypatch.undo()
    mgr.close()
    assert sorted(os.listdir(ckpt)) == ["2", "3.tmp"]
    again = CheckpointManager(str(ckpt))
    assert again.latest_step() == 2 and sorted(os.listdir(ckpt)) == ["2"]
    _, step = again.restore(_small_state(seed=3))
    assert step == 2
    again.close()


def test_reset_then_resave_the_same_steps(tmp_path):
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2)
    mgr.save(2, state)
    mgr.save(4, state)
    mgr.reset()  # queued after the two saves
    assert mgr.latest_step() is None
    assert mgr.save(2, state)
    mgr.close()
    assert os.listdir(tmp_path / "ckpt") == ["2"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_snapshot_is_taken_before_a_later_in_place_update(tmp_path):
    """The saved state is the one at ``save``, not at the write: an
    in-place Adam step right after ``save`` does not reach the file."""
    state = _small_state()
    before = {k: v.clone() for k, v in _tensors(state).items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state)
    state.optimizer.zero_grad()
    state.model(torch.ones((1, 6))).sum().backward()
    state.optimizer.step()
    assert any(not torch.equal(v, before[k]) for k, v in _tensors(state).items())
    _assert_equal_states(mgr.restore(_small_state(seed=2))[0], before)
    mgr.close()


def _loop_cfg(tmp_path, name):
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width = 64, 96
    cfg.data.frame_offsets = (1,)
    cfg.data.batch_size = 2
    cfg.data.augment = False
    cfg.train.log_every = 1
    cfg.train.ckpt_every_steps = 2
    cfg.train.ckpt_dir = str(tmp_path / name / "ckpt")
    return cfg


def test_kill_and_resume_bitwise(tmp_path):
    """Train 4 steps and checkpoint at 2 and 4; 'kill' after step 2 (a
    directory holding only step 2), resume to step 4: the model and Adam
    moments equal the uninterrupted run's bit for bit. The resume skips the
    consumed batches by position, which reproduces the stream inside the
    first epoch (5 steps here)."""
    seq = render_sequence(n_frames=12, height=64, width=96, seed=3)
    ds = SnippetDataset([seq.frames], [seq.k], (1,))
    cfg_a = _loop_cfg(tmp_path, "a")
    _, straight = train_loop(cfg_a, ds, log_dir=str(tmp_path / "a" / "log"), max_steps=4,
                             device="cpu")
    assert straight.step == 4 and straight.steps_per_epoch == 5
    cfg_b = _loop_cfg(tmp_path, "b")
    os.makedirs(cfg_b.train.ckpt_dir)
    shutil.copytree(os.path.join(cfg_a.train.ckpt_dir, "2"),
                    os.path.join(cfg_b.train.ckpt_dir, "2"))
    _, resumed = train_loop(cfg_b, ds, log_dir=str(tmp_path / "b" / "log"), max_steps=4,
                            resume=True, device="cpu")
    assert resumed.step == 4
    _assert_equal_states(resumed, straight)
    saved_a = CheckpointManager(cfg_a.train.ckpt_dir).load(4)[0]
    saved_b = CheckpointManager(cfg_b.train.ckpt_dir).load(4)[0]
    for part in ("model", "optimizer"):
        flat_a = {k: v for k, v in _flatten(saved_a[part])}
        flat_b = {k: v for k, v in _flatten(saved_b[part])}
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            if isinstance(flat_a[k], torch.Tensor):
                assert torch.equal(flat_a[k], flat_b[k]), k
            else:
                assert flat_a[k] == flat_b[k], k
    rows_b = [r for r in _jsonl(tmp_path / "b" / "log") if "loss/total" in r]
    rows_a = [r for r in _jsonl(tmp_path / "a" / "log") if "loss/total" in r]
    assert [r["step"] for r in rows_b] == [3, 4]
    assert [r["loss/total"] for r in rows_b] == [r["loss/total"] for r in rows_a[2:]]


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def _jsonl(log_dir):
    import json

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_load_returns_cpu_tensors_and_python_values(tmp_path):
    """What ``load`` returns is plain CPU tensors and Python values."""
    state = _small_state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(5, state)
    payload, step, loader = mgr.load()
    assert step == 5 and loader is None
    assert set(payload) == {"model", "optimizer", "step", "steps_per_epoch"}
    assert all(v.device.type == "cpu" for v in payload["model"].values())
    np.testing.assert_array_equal(payload["model"]["0.weight"].numpy(),
                                  state.model[0].weight.detach().numpy())
    mgr.close()
