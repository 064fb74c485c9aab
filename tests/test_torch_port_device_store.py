"""colvo_torch's device-resident corpus, its on-device augmentation, the
K-step train chunk and the device loader of the training loop, against
colvo's on the CPU: the store's frames, table and batches bit for bit, the
augmentation's arithmetic on the reference's own draws, the chunk against
the port's and the reference's plain steps, the device forms of the
learning rate and the geo ramp, and the loop's losses on the device
loader."""

import json
import math
import types
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colvo.runtime.loop as jax_loop
from colvo.config import ColvoConfig as JaxConfig
from colvo.config import DataConfig as JaxDataConfig
from colvo.data.device_store import DeviceSnippetStore as JaxStore
from colvo.data.device_store import device_augment as jax_device_augment
from colvo.models import ColVOModel as JaxModel
from colvo.runtime.train_step import TrainState as JaxState
from colvo.runtime.train_step import make_optimizer, make_train_step
from colvo_torch.config import ColvoConfig, DataConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.data.device_store import (
    DeviceSnippetStore,
    apply_augment,
    device_augment,
    draw_augment,
    gather,
)
from colvo_torch.pipelines import make_training_eval_hook
from colvo_torch.runtime import (
    flax_params,
    geo_scale,
    geo_scale_t,
    init_state,
    learning_rate,
    learning_rate_t,
    loss_fn,
    make_scan_train,
    train_step,
)
from colvo_torch.runtime import train as train_loop

torch.set_num_threads(2)

HW = 64


@pytest.fixture(scope="module")
def seq():
    # the reference's test_device_store.py sequence (seed 4 has texture
    # enough at 64×64 for the steps to move the loss)
    return render_sequence(n_frames=12, height=HW, width=HW, seed=4)


def _data_cfgs(**kw):
    return (JaxDataConfig(height=HW, width=HW, batch_size=4, **kw),
            DataConfig(height=HW, width=HW, batch_size=4, **kw))


def _stores(sequences, ks, offsets=(-1, 1)):
    return JaxStore(sequences, ks, offsets), DeviceSnippetStore(sequences, ks, offsets,
                                                                device="cpu")


def test_store_equals_the_reference(seq):
    """uint8 frames (float input quantised by the reference's expression),
    the (S, F) int32 table, K and the snippet count, bit for bit; uint8
    input is taken as it is."""
    u8 = (seq.frames * 255).astype(np.uint8)
    for sequences in ([seq.frames, seq.frames[3:]], [u8]):
        ref, port = _stores(sequences, [seq.k] * len(sequences))
        assert port.frames.dtype == torch.uint8 and port.table.dtype == torch.int32
        np.testing.assert_array_equal(port.frames.numpy(), np.asarray(ref.frames))
        np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
        np.testing.assert_array_equal(port.k.numpy(), np.asarray(ref.k))
        assert port.n_snippets == ref.n_snippets == len(port.table)


def test_two_epochs_of_batches_equal_the_reference(seq):
    jcfg, cfg = _data_cfgs(augment=False)
    ref, port = _stores([seq.frames, seq.frames[::-1]], [seq.k, seq.k], (1,))
    want = list(ref.batches(jcfg, seed=0, epochs=2))
    # a batch is its program's static outputs, which the next overwrites
    got = [{key: v.clone() for key, v in b.items()} for b in port.batches(cfg, seed=0, epochs=2)]
    assert len(got) == len(want) == 2 * (port.n_snippets // cfg.batch_size)
    for b, a in zip(got, want):
        assert b["frames"].shape == (4, 2, HW, HW, 3) and b["frames"].dtype == torch.float32
        for key in ("frames", "frames_clean", "k"):
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]), err_msg=key)


def test_store_rejects_an_unshared_k_and_needs_a_card_unless_told_cpu(seq):
    k2 = seq.k.copy()
    k2[0, 0] *= 2
    with pytest.raises(ValueError, match="single shared K"):
        DeviceSnippetStore([seq.frames, seq.frames], [seq.k, k2], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceSnippetStore([seq.frames], [seq.k])
    port = DeviceSnippetStore([seq.frames[:4]], [seq.k], device="cpu")
    with pytest.raises(ValueError, match="batch_size=4"):
        next(port.batches(_data_cfgs()[1]))


@pytest.mark.parametrize("key", [1, 7])
def test_apply_augment_matches_the_reference_on_its_draws(key):
    """The reference's device_augment at jax.random.key(key) against
    apply_augment fed the draws it makes (the same split and uniform
    calls as colvo/data/device_store.py:40-64), to 1e-6 abs."""
    jcfg, cfg = _data_cfgs()
    frames = np.random.default_rng(key).random((8, 3, 16, 20, 3), dtype=np.float32)
    want_aug, want_clean = jax_device_augment(jnp.asarray(frames), jax.random.key(key), jcfg)
    k_flip, k_b, k_c, k_s, k_h = jax.random.split(jax.random.key(key), 5)
    shape = (8, 1, 1, 1, 1)
    draws = {"flip": jax.random.bernoulli(k_flip, 0.5, (8,))}
    for name, k_ in (("brightness", k_b), ("contrast", k_c), ("saturation", k_s)):
        a = getattr(jcfg, name)
        draws[name] = jax.random.uniform(k_, shape, minval=1 - a, maxval=1 + a)
    draws["hue"] = jax.random.uniform(k_h, shape, minval=-jcfg.hue, maxval=jcfg.hue)
    draws = {k: torch.from_numpy(np.array(v).reshape(8)) for k, v in draws.items()}
    assert 0 < int(draws["flip"].sum()) < 8
    aug, clean = apply_augment(torch.from_numpy(frames), draws, cfg)
    np.testing.assert_allclose(clean.numpy(), np.asarray(want_clean), rtol=0, atol=0)
    np.testing.assert_allclose(aug.numpy(), np.asarray(want_aug), rtol=0, atol=1e-6)


def test_store_augment_contract(seq):
    """test_device_store.py::test_store_augment_contract on the port:
    jitter on, output in [0, 1], the same jitter on every frame of a
    snippet (per-frame mean shifts equal)."""
    _, cfg = _data_cfgs(augment=True)
    port = DeviceSnippetStore([seq.frames], [seq.k], cfg.frame_offsets, device="cpu")
    b = next(port.batches(cfg, seed=0, epochs=1))
    aug, clean = b["frames"].numpy(), b["frames_clean"].numpy()
    assert not np.allclose(aug, clean)
    assert aug.min() >= 0 and aug.max() <= 1
    for row in range(cfg.batch_size):
        shift = (aug - clean)[row].reshape(3, -1).mean(axis=1)
        assert np.ptp(shift) < 0.02


def test_device_augment_flip_shared_and_applied_to_clean():
    """test_device_store.py::test_device_augment_flip_shared_and_clean on
    the port: with the jitter off, aug is clean, and some snippets (all of
    their frames) come out flipped, not all."""
    _, cfg = _data_cfgs(brightness=0, contrast=0, saturation=0, hue=0, hflip=True)
    frames = torch.from_numpy(np.random.default_rng(0).random((8, 2, 16, 16, 3),
                                                               dtype=np.float32))
    gen = torch.Generator().manual_seed(1)
    aug, clean = device_augment(frames, gen, cfg)
    torch.testing.assert_close(aug, clean, rtol=0, atol=0)
    flipped = [torch.equal(clean[i], frames[i].flip(2)) for i in range(8)]
    kept = [torch.equal(clean[i], frames[i]) for i in range(8)]
    assert all(f != k for f, k in zip(flipped, kept))
    assert any(flipped) and not all(flipped)
    gen.manual_seed(1)
    assert set(draw_augment(8, gen, cfg, "cpu")) == {"flip"}


@pytest.mark.parametrize("warmup,ramp", [(0, 0), (3, 4), (10, 25)])
def test_device_learning_rate_and_geo_ramp_equal_the_host_forms(warmup, ramp):
    """learning_rate_t / geo_scale_t of a step tensor equal float32 of the
    host functions at every step from 0 across the warmup's end and the
    decay (3 epochs of 5 steps, behind the warmup)."""
    cfg = ColvoConfig()
    cfg.train.warmup_steps, cfg.train.lr_decay_epochs = warmup, 3
    cfg.loss.geo_ramp_steps = ramp
    for step in range(warmup + 20):
        t = torch.tensor(step)
        lr = learning_rate_t(cfg, t, steps_per_epoch=5)
        assert lr.dtype == torch.float32 and lr.shape == ()
        assert lr.item() == np.float32(learning_rate(cfg, step, 5)), step
        geo = geo_scale_t(cfg, t)
        if ramp:
            assert geo.dtype == torch.float32 and geo.item() == np.float32(geo_scale(cfg, step))
        else:
            assert geo == geo_scale(cfg, step) == 1.0
    lrs = {learning_rate(cfg, s, 5) for s in range(warmup + 20)}
    assert {cfg.train.lr, cfg.train.lr * cfg.train.lr_decay_factor} <= lrs


def _chunk_configs():
    """test_device_store.py::test_scan_train_chunk_matches_plain_steps's
    configuration, for both packages."""
    cfgs = JaxConfig(), ColvoConfig()
    for cfg in cfgs:
        cfg.model.dtype = "float32"
        cfg.model.n_scales = 2
        cfg.data.height = cfg.data.width = HW
        cfg.data.batch_size = 2
        cfg.data.frame_offsets = (1,)
        cfg.data.augment = False
        cfg.train.lr = 1e-3
    return cfgs


def _flax(state):
    """The state's weights as the reference's params (copies: the port's
    steps update its weights in place)."""
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    return flax.traverse_util.unflatten_dict(flax_params(weights), sep="/")


def test_scan_chunk_matches_the_ports_and_the_references_plain_steps(seq):
    """A one-snippet corpus with augmentation off makes every draw index 0.
    A chunk of 3 steps, then another: 6 steps counted on the host and on
    the device, finite losses. The first chunk's metrics equal 3 of the
    port's train_steps on the same batch to 1e-5 relative, and its losses
    the reference's make_train_step from the same weights at the
    reference's own tolerances (1e-4, 1e-3, 1e-2 relative, 1e-5 abs)."""
    jcfg, cfg = _chunk_configs()
    ref_store, store = _stores([np.asarray(seq.frames[:2])], [seq.k], cfg.data.frame_offsets)
    assert store.n_snippets == 1
    n_steps = 3
    state = init_state(cfg, seed=0, device="cpu")
    weights = _flax(state)
    chunk = make_scan_train(state, cfg, n_steps)
    gen = torch.Generator().manual_seed(1)
    state, metrics = chunk(state, store.frames, store.table, store.k, gen)
    assert all(v.shape == (n_steps,) for v in metrics.values())
    assert torch.isfinite(metrics["loss/total"]).all()
    assert state.step == n_steps and int(chunk.step) == n_steps
    assert torch.equal(chunk.indices, torch.zeros((n_steps, 2), dtype=torch.int64))
    state, metrics2 = chunk(state, store.frames, store.table, store.k, gen)
    assert state.step == int(chunk.step) == 2 * n_steps
    assert torch.isfinite(metrics2["loss/total"]).all()
    with pytest.raises(ValueError, match="state it was made for"):
        chunk(init_state(cfg, seed=0, device="cpu"), store.frames, store.table, store.k, gen)

    snippet = gather(store.frames, store.table, torch.zeros(2, dtype=torch.int64))
    batch = {"frames": snippet, "frames_clean": snippet, "k": store.k}
    plain = init_state(cfg, seed=0, device="cpu")
    for i in range(n_steps):
        m = train_step(plain, batch, cfg)
        for key, v in m.items():
            np.testing.assert_allclose(metrics[key][i].item(), v.item(), rtol=1e-5, atol=1e-9,
                                       err_msg=f"{key} at step {i + 1}")

    tx = make_optimizer(jcfg)
    step_fn = make_train_step(JaxModel(jcfg.model), tx, jcfg)
    jsnippet = ref_store._assemble(ref_store.frames, ref_store.table, jnp.zeros(2, jnp.int32))
    np.testing.assert_array_equal(np.asarray(jsnippet), snippet.numpy())
    jstate = JaxState(weights, tx.init(weights), jnp.zeros((), jnp.int32))
    jbatch = {"frames": jsnippet, "frames_clean": jsnippet, "k": ref_store.k}
    for i, tol in enumerate((1e-4, 1e-3, 1e-2)):
        jstate, m = step_fn(jstate, jbatch)
        np.testing.assert_allclose(metrics["loss/total"][i].item(), float(m["loss/total"]),
                                   rtol=tol, atol=1e-5, err_msg=f"step {i + 1}")


def test_inverse_without_a_host_check_gives_the_same_loss(seq):
    """linalg.inv_ex (which checks nothing on the host) in place of
    linalg.inv: the same loss and terms, bit for bit."""
    _, cfg = _chunk_configs()
    store = DeviceSnippetStore([seq.frames[:5]], [seq.k], cfg.data.frame_offsets, device="cpu")
    frames = gather(store.frames, store.table, torch.tensor([0, 3]))
    batch = {"frames": frames, "frames_clean": frames, "k": store.k}
    model = init_state(cfg, seed=2, device="cpu").model
    with torch.no_grad():
        _, got = loss_fn(model, batch, cfg)
        inv = torch.linalg.inv
        with mock.patch.object(torch.linalg, "inv_ex",
                               lambda a: types.SimpleNamespace(inverse=inv(a))):
            _, want = loss_fn(model, batch, cfg)
    assert got.keys() == want.keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key


def test_loop_on_the_device_loader_tracks_the_reference_loop(seq, tmp_path):
    """train() with data.loader='device' and augmentation off, from the same
    weights as colvo's loop on its own device loader: the loss/total rows of
    3 steps agree at the reference's per-step tolerances for two equivalent
    programs run apart (1e-4, 1e-3, 1e-2 relative; test_device_store.py:
    149-152). Runs apart drift as test_torch_port_train_step.py's docstring
    says: Adam moves weights whose gradients sit at float32 noise by ±lr,
    and a near-tie automask decision moves step 1's gradient (grad_norm
    2.4e-3 apart here), so the rows measured 4e-7, 1.6e-5 and 2.1e-3
    apart. As test_device_store.py::test_train_loop_with_device_loader: the
    eval hook's rows (ATE and RPE among them) and its three panels."""
    jcfg, cfg = JaxConfig(), ColvoConfig()
    for c in (jcfg, cfg):
        c.model.dtype = "float32"
        c.model.n_scales = 2
        c.data.height = c.data.width = HW
        c.data.batch_size = 4  # 11 snippets: 2 steps an epoch, the hook at step 2
        c.data.frame_offsets = (1,)
        c.data.loader = "device"
        c.data.augment = False
        c.train.log_every = 1
        c.train.eval_every_epochs = 1
        c.train.ckpt_dir = str(tmp_path / f"ckpt_{type(c).__module__}")
    jcfg.mesh.data_parallel = 1
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    steps_per_epoch = len(ds) // cfg.data.batch_size
    weights = _flax(init_state(cfg, device="cpu", steps_per_epoch=steps_per_epoch))
    real_init = jax_loop.init_state

    def same_weights(cfg_, rng, spe):
        model, state = real_init(cfg_, rng, spe)
        return model, JaxState(weights, make_optimizer(cfg_, spe).init(weights), state.step)

    with mock.patch.object(jax_loop, "init_state", same_weights):
        jax_loop.train(jcfg, ds, log_dir=str(tmp_path / "ref"), max_steps=3)
    _, state = train_loop(cfg, ds, log_dir=str(tmp_path / "port"), max_steps=3,
                          eval_hook_factory=make_training_eval_hook, device="cpu")
    assert state.step == 3
    rows = {}
    for name in ("ref", "port"):
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    want = [(r["step"], r["loss/total"]) for r in rows["ref"] if "loss/total" in r]
    got = [(r["step"], r["loss/total"]) for r in rows["port"] if "loss/total" in r]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (s, g), (_, w), tol in zip(got, want, (1e-4, 1e-3, 1e-2)):
        assert math.isfinite(g) and g == pytest.approx(w, rel=tol), (s, g, w)
    eval_keys = {k for r in rows["port"] for k in r if k.startswith("eval/")}
    assert {"eval/ate", "eval/rpe_trans", "eval/rpe_rot_deg"} <= eval_keys, eval_keys
    panels = list((tmp_path / "port").glob("panels_*.png"))
    assert {p.name.rsplit("_", 1)[0] for p in panels} == {
        "panels_disp", "panels_automask", "panels_warp_error"}, panels
