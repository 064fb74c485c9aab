"""colvo_torch.runtime.mesh: data parallel over torch.distributed (gloo) in
two processes on the CPU, held against the port's single-process step on
the same global batch, as the reference's test_dp_step_equals_single_device
(tests/test_train_smoke.py) holds its sharded step against one device.

The ranks are this file run as a script (``python test_torch_port_mesh.py
<mode> <out>`` with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set), so
that no JAX-importing ``conftest.py`` loads in them.
"""

import importlib
import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
from colvo_torch.runtime import init_state, loss_fn, to_device, train_step
from colvo_torch.runtime import mesh as mesh_mod

# the module (``colvo_torch.runtime.train_step`` names the function)
train_step_mod = importlib.import_module("colvo_torch.runtime.train_step")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL_LOSS_REL = 1e-5  # loss terms, relative
TOL_GRAD = 1e-4  # gradients, of max |g|


def tiny_config(batch_size=8):
    """test_train_smoke.py's DP configuration: 32×32, B=8, two scales, one
    source; gauge and geo on (their defaults)."""
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height = cfg.data.width = 32
    cfg.data.batch_size = batch_size
    cfg.data.frame_offsets = (1,)
    cfg.data.augment = False
    cfg.train.lr = 3e-4
    assert cfg.loss.gauge_weight > 0 and cfg.loss.geometric_weight > 0
    return cfg


def global_batch(cfg):
    seq = render_sequence(n_frames=12, height=cfg.data.height, width=cfg.data.width, seed=11)
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    return next(batch_iterator(ds, cfg.data, seed=0))


def _step_with_grads(state, batch, cfg):
    """``train_step`` with the gradients the clip receives (all-reduced
    under a mesh, before clipping) recorded."""
    grads = []
    clip = train_step_mod.clip_by_global_norm

    def recording(gs, max_norm):
        grads.extend(g.detach().clone() for g in gs)
        return clip(gs, max_norm)

    with mock.patch.object(train_step_mod, "clip_by_global_norm", recording):
        metrics = train_step(state, batch, cfg)
    return {k: float(v) for k, v in metrics.items()}, [g.numpy() for g in grads]


def _weights(state):
    return [p.detach().numpy().copy() for p in state.model.parameters()]


def _objects(arrays):
    """A list of arrays of any shapes as one object array for ``np.savez``."""
    out = np.empty(len(arrays), dtype=object)
    out[:] = arrays
    return out


# ----------------------------------------------------------------- workers


def _worker_step(out: str) -> None:
    """One data-parallel step on this rank's rows of the global batch."""
    assert mesh_mod.maybe_init_distributed()
    cfg = tiny_config()
    mesh = mesh_mod.make_mesh(cfg.mesh)
    assert mesh.size == WORLD
    batch = global_batch(cfg)
    rows = to_device(mesh_mod.shard_batch(batch, mesh), torch.device("cpu"))
    state = init_state(cfg, seed=0, device="cpu")
    if mesh.rank == 1:  # replicate_tree must give every rank rank 0's weights
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    mesh_mod.replicate_tree(state.model, mesh)
    state.mesh = mesh
    with torch.no_grad():  # this rank's rows alone, as one process would see them
        local, _ = loss_fn(state.model, rows, cfg)
    metrics, grads = _step_with_grads(state, rows, cfg)
    np.savez(out, local=float(local), grads=_objects(grads), weights=_objects(_weights(state)),
             **{f"m/{k}": v for k, v in metrics.items()})
    mesh_mod.cross_process_barrier("done")
    torch.distributed.destroy_process_group()


def _worker_train(out: str, ckpt_dir: str, log_dir: str, resume: str) -> None:
    """``pipelines.train`` under the process group; the final weights."""
    from colvo_torch import pipelines

    # TensorBoard is optional to the metrics writer; importing it here
    # loads TensorFlow, which takes longer than the run
    sys.modules["torch.utils.tensorboard"] = None

    assert mesh_mod.maybe_init_distributed()
    cfg = tiny_config()
    cfg.train.ckpt_dir, cfg.train.ckpt_every_steps, cfg.train.log_every = ckpt_dir, 2, 1
    _, state = pipelines.train(cfg, log_dir=log_dir, max_steps=4, resume=resume == "1",
                               device="cpu")
    np.savez(out, weights=_objects(_weights(state)))
    torch.distributed.destroy_process_group()


# -------------------------------------------------------------------- tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, mode, *args, timeout=240):
    """Run ``WORLD`` ranks of this file in ``mode``; returns each rank's
    output file (``.npz``). A rank that fails or times out fails the test
    with every rank's full output."""
    return _wait(*_start(tmp_path, mode, *args), timeout=timeout)


def _start(tmp_path, mode, *args):
    port = _free_port()
    procs, outs = [], []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out = str(tmp_path / f"{mode}_rank{rank}.npz")
        outs.append(out)
        procs.append(subprocess.Popen([sys.executable, __file__, mode, out, *args], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, outs


def _wait(procs, outs, timeout=240):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log}"
    results = []
    for out in outs:  # read into memory and removed: the weights are ~100 MB a rank
        with np.load(out, allow_pickle=True) as f:
            results.append({k: f[k] for k in f.files})
        os.remove(out)
    return results


def test_two_process_step_equals_the_single_process_step(tmp_path):
    """Two gloo ranks, 4 rows each, against one process on all 8: the loss
    terms to 1e-5 relative, the all-reduced pre-clip gradients to 1e-4 of
    max |g|, the weights after Adam within 2.5·lr (the first Adam update is
    ±lr·sign(g), so a sign flip of a near-zero gradient moves a weight by
    2·lr). Both ranks hold the same bits. The mean of the ranks' local
    losses misses the global loss by more than the bound: the global
    reductions are what makes the step right."""
    started = _start(tmp_path, "step")
    cfg = tiny_config()  # the single process, while the ranks run
    state = init_state(cfg, seed=0, device="cpu")
    metrics, grads = _step_with_grads(state, to_device(global_batch(cfg), torch.device("cpu")),
                                      cfg)
    weights = _weights(state)
    ranks = _wait(*started)
    keys = sorted(metrics)
    assert {k[2:] for k in ranks[0] if k.startswith("m/")} == set(keys)
    for k in keys:
        assert ranks[0][f"m/{k}"] == ranks[1][f"m/{k}"], k
        got = float(ranks[0][f"m/{k}"])
        # The gauge hinge squares log r − log lo, which is ~0.02 here, so
        # the float noise of its two global means (the summation order:
        # two partial sums, not one) grows ~100× in it relative to itself.
        # It is held to the bound relative to the total it joins; its
        # input r relative to itself.
        scale = abs(metrics["loss/total"] if k == "loss/gauge" else metrics[k])
        assert abs(got - metrics[k]) <= TOL_LOSS_REL * max(scale, 1e-6), (k, got, metrics[k])
    for part in ("grads", "weights"):
        for a, b in zip(ranks[0][part], ranks[1][part]):
            np.testing.assert_array_equal(a, b)
    gmax = max(np.abs(g).max() for g in grads)
    assert len(ranks[0]["grads"]) == len(grads)
    for got, want in zip(ranks[0]["grads"], grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRAD * gmax)
    for got, want in zip(ranks[0]["weights"], weights):
        np.testing.assert_allclose(got, want, rtol=0, atol=2.5 * cfg.train.lr)
    local_mean = 0.5 * (float(ranks[0]["local"]) + float(ranks[1]["local"]))
    total = metrics["loss/total"]
    assert abs(local_mean - total) > 10 * TOL_LOSS_REL * abs(total), (local_mean, total)


def test_two_process_train_writes_once_and_resumes_bitwise(tmp_path):
    """``pipelines.train`` on two ranks, 4 steps, checkpoints at 2 and 4:
    one metrics row a step (rank 0 alone writes), the ranks' final weights
    equal; a two-rank resume from a copy of step 2 ends on the same bits."""
    import json
    import shutil

    try:  # (a checkpoint with Adam's moments is ~300 MB: none is left behind)
        a = _launch(tmp_path, "train", str(tmp_path / "a" / "ckpt"),
                    str(tmp_path / "a" / "log"), "0")
        assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["2", "4"]
        rows = [json.loads(line) for line in open(tmp_path / "a" / "log" / "metrics.jsonl")]
        assert [r["step"] for r in rows if "loss/total" in r] == [1, 2, 3, 4]
        for x, y in zip(a[0]["weights"], a[1]["weights"]):
            np.testing.assert_array_equal(x, y)
        shutil.rmtree(tmp_path / "a" / "ckpt" / "4")
        os.makedirs(tmp_path / "b" / "ckpt")
        shutil.move(tmp_path / "a" / "ckpt" / "2", tmp_path / "b" / "ckpt" / "2")
        b = _launch(tmp_path, "train", str(tmp_path / "b" / "ckpt"),
                    str(tmp_path / "b" / "log"), "1")
        for rank in range(WORLD):
            for x, y in zip(a[0]["weights"], b[rank]["weights"]):
                np.testing.assert_array_equal(x, y)
    finally:
        shutil.rmtree(tmp_path / "a", ignore_errors=True)
        shutil.rmtree(tmp_path / "b", ignore_errors=True)


def test_alone_nothing_is_initialised_and_the_mesh_is_one(monkeypatch):
    """Without a launcher's variables ``maybe_init_distributed`` is a no-op,
    the mesh is one rank whose reductions are torch.sum and torch.mean,
    and the batch is not split."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_mod.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert mesh_mod.cross_process_barrier("x") is False
    mesh = mesh_mod.make_mesh(tiny_config().mesh)
    assert (mesh.size, mesh.rank) == (1, 0)
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(mesh.sum(x), torch.sum(x)) and torch.equal(mesh.mean(x), torch.mean(x))
    batch = {"frames": np.zeros((4, 2)), "k": np.eye(3)}
    assert mesh_mod.shard_batch(batch, mesh)["frames"] is batch["frames"]
    with pytest.raises(ValueError, match="does not split"):
        mesh_mod.shard_batch({"frames": np.zeros((5, 2))}, mesh_mod.Mesh(2, 1))
    assert mesh_mod.shard_batch(batch, mesh_mod.Mesh(2, 1))["frames"].shape == (2, 2)


if __name__ == "__main__":
    mode, out_path, *rest = sys.argv[1:]
    {"step": _worker_step, "train": _worker_train}[mode](out_path, *rest)
