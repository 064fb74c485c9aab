"""colvo_torch's off-default training configurations on the CPU, part
two (``test_torch_port_knobs.py`` holds the float32 loss protocols against
colvo): ``compute_dtype="bfloat16"`` at the reference's own bounds, the
pooled geo grid of ``geo_res_cap`` against finite differences of the
reference's loss, ``model.remat`` and ``model.batched_snippet=false``
against colvo's model, the exact-math knobs against the port's default,
``train.adam_mu_dtype="bfloat16"`` against optax (with checkpoints and the
K-step chunk), and ``train.deterministic`` in the loop.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colvo.config import ColvoConfig as JaxConfig
from colvo.losses.total import snippet_loss as jax_snippet_loss
from colvo.models import ColVOModel as JaxModel
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
from colvo_torch.data.device_store import DeviceSnippetStore, gather
from colvo_torch.losses.total import snippet_loss
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import (
    CheckpointManager,
    flax_params,
    init_state,
    loss_fn,
    make_scan_train,
    params_from_flax,
    to_device,
    train_step,
)
from colvo_torch.runtime import train as train_loop
from colvo_torch.runtime.optim import Adam
from test_torch_port_knobs import _loss_both
from test_torch_port_losses import B, H, W, _check_aux, _loss_inputs, _rel, _t

torch.set_num_threads(2)


def _cos(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _bf16_fixture():
    """tests/test_losses.py::test_compute_dtype_close_to_f32_and_grads_flow's
    inputs, by its recipe: one 32×32 snippet of uniform noise, two scales,
    disparities uniform in (0.05, 0.95), poses of scale 0.01."""
    rng = np.random.default_rng(0)
    h = w = 32
    frames = rng.random((1, 3, h, w, 3)).astype(np.float32)
    k = np.array([[0.58 * w, 0, w / 2], [0, 0.92 * h, h / 2], [0, 0, 1]], np.float32)
    disps = [{s: (0.05 + 0.9 * rng.random((1, h >> s, w >> s, 1))).astype(np.float32)
              for s in range(2)} for _ in range(3)]
    poses = (0.01 * rng.standard_normal((1, 2, 6))).astype(np.float32)
    return disps, poses, frames, k


def _bf16_run(knobs, package):
    cfg = JaxConfig() if package == "colvo" else ColvoConfig()
    cfg.model.n_scales = 2
    for k, v in knobs.items():
        setattr(cfg.loss, k, v)
    disps, poses, frames, k = _bf16_fixture()
    k_inv = np.linalg.inv(k).astype(np.float32)
    if package == "colvo":
        loss, (_, gp) = jax.jit(jax.value_and_grad(
            lambda d, p: jax_snippet_loss(d, p, jnp.asarray(frames), k, k_inv, cfg.loss,
                                          cfg.model)[0], argnums=(0, 1)))(disps, poses)
        return float(loss), np.asarray(gp), []
    tdisps = [{s: _t(v, True) for s, v in d.items()} for d in disps]
    tposes = _t(poses, True)
    loss, _ = snippet_loss(tdisps, tposes, _t(frames), _t(k), _t(k_inv), cfg.loss, cfg.model)
    loss.backward()
    return loss.item(), tposes.grad.numpy(), [d[s].grad for d in tdisps for s in d]


@pytest.mark.parametrize("base", [{"lcc_mode": "global+affine"},
                                  {"lcc_mode": "global+affine", "batched_photo": True},
                                  {}], ids=["global_affine", "batched_photo", "affine"])
def test_bf16_planes_within_the_reference_bounds(base):
    """compute_dtype="bfloat16" on the reference's own bf16 fixture: the
    port's bf16 loss within 5e-2 relative of its f32 loss, its pose
    gradient at cosine > 0.97 to its f32 gradient (the reference's
    bounds), finite gradients, and its loss within 5e-2 relative of the
    reference's bf16 loss. (On smooth rendered frames the windowed LCC
    statistics cancel in bf16 in both packages, far past these bounds:
    ROADMAP.md §C.)"""
    f32_l, f32_gp, _ = _bf16_run(base, "colvo_torch")
    knobs = {**base, "compute_dtype": "bfloat16"}
    bf_l, bf_gp, bf_gd = _bf16_run(knobs, "colvo_torch")
    ref_l, ref_gp, _ = _bf16_run(knobs, "colvo")
    assert all(torch.isfinite(g).all() for g in bf_gd) and np.isfinite(bf_gp).all()
    rel_f32 = abs(bf_l - f32_l) / abs(f32_l)
    cos = _cos(bf_gp, f32_gp)
    rel_ref = abs(bf_l - ref_l) / abs(ref_l)
    print(f"bf16 {base}: loss vs own f32 {rel_f32:.3g}, pose-grad cosine {cos:.5f}; loss vs "
          f"reference bf16 {rel_ref:.3g}, pose-grad cosine to it {_cos(bf_gp, ref_gp):.5f}")
    assert rel_f32 < 5e-2 and cos > 0.97 and rel_ref < 5e-2


@pytest.mark.parametrize("knobs", [{"geo_res_cap": 32}, {"photo_native": True, "geo_res_cap": 32}],
                         ids=["cap32", "photo_native_cap32"])
def test_pooled_geo_grid_gradients_follow_the_references_finite_differences(knobs):
    """At 64×96 a cap of 32 pools scale 0's geo grid, whose weights then
    upsample onto the photometric grid. There the reference's autodiff
    gradient to the source disparities strays from its own loss: at the
    pixels where the two packages differ most, the port's gradient equals
    the central finite difference of the reference's loss (step 1e-2) to
    3 %, the reference's does not. (The pose gradients differ by up to
    1.5e-2 relative L2 from the same cause; the loss is too kinked in the
    poses for a finite difference to arbitrate.) Loss and aux agree at the
    float32 tolerances."""
    jcfg = JaxConfig()
    for k, v in knobs.items():
        setattr(jcfg.loss, k, v)
    (jl, jaux, gd, gp), (tl, taux, tdisps, tposes) = _loss_both(knobs, seed=5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    disps, poses, frames, k = _loss_inputs(5)
    k_inv = np.linalg.inv(k).astype(np.float32)
    ref_loss = jax.jit(lambda d, p: jax_snippet_loss(d, p, jnp.asarray(frames), k, k_inv,
                                                     jcfg.loss, jcfg.model)[0])
    strays = 0

    def check(port, ref, bump, h):
        """port's and ref's gradient at one input against the central
        difference of the reference's loss, ``bump(sign)`` its inputs."""
        fd = (float(ref_loss(*bump(h))) - float(ref_loss(*bump(-h)))) / (2 * h)
        assert abs(port - fd) <= 3e-2 * abs(fd), (port, fd, ref)
        return abs(ref - fd) > 3e-2 * abs(fd)

    def bump_disp(f, idx):
        def bump(h):
            d = [{s: v.copy() for s, v in x.items()} for x in disps]
            d[f][0][idx] += h
            return d, poses
        return bump

    for f in (1, 2):
        port, ref = tdisps[f][0].grad.numpy(), np.asarray(gd[f][0])
        for flat in np.argsort(-np.abs(port - ref), axis=None)[:2]:
            idx = np.unravel_index(flat, port.shape)
            strays += check(port[idx], ref[idx], bump_disp(f, idx), 3e-2)
    assert strays > 0


# ----------------------------------------------------------------- models

def _model_configs(**knobs):
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        cfg.model.dtype = "float32"
        for k, v in knobs.items():
            setattr(cfg.model, k, v)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model_inputs():
    _, tcfg = _model_configs()
    model = ColVOModel(tcfg.model)
    model.reset_parameters(torch.Generator().manual_seed(5))
    frames = np.random.default_rng(6).random((B, 3, H, W, 3), dtype=np.float32)
    return flax_params(model.state_dict()), frames


def _outputs_scalar(disps, poses, xp):
    """A scalar that every output reaches, with weights that differ by
    frame and scale."""
    total = xp.sum(poses * xp.arange(1, 7, dtype=poses.dtype))
    for f, d in enumerate(disps):
        for s in sorted(d):
            total = total + (f + 1) * (s + 2) * xp.mean(d[s] ** 2)
    return total


@pytest.mark.parametrize("knob,value", [("remat", True), ("batched_snippet", False)])
def test_model_knobs_match_the_reference_forward_and_gradients(model_inputs, knob, value):
    """model.remat and model.batched_snippet=false, each in both packages
    from the same weights: disparities and poses to 1e-4
    (test_torch_port_models.py's tolerance), every parameter's gradient of
    a scalar of all outputs to 1e-3 relative L2 (as the train-step test),
    and the state_dict keys the default model has."""
    weights, frames = model_inputs
    jcfg, tcfg = _model_configs(**{knob: value})
    jm = JaxModel(jcfg.model)
    params = flax.traverse_util.unflatten_dict(weights, sep="/")

    def jf(p):
        d, pose = jm.apply(p, jnp.asarray(frames))
        return _outputs_scalar(d, pose, jnp), (d, pose)

    (jv, (jd, jp)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    model = ColVOModel(tcfg.model)
    assert list(model.state_dict()) == list(ColVOModel(_model_configs()[1].model).state_dict())
    model.load_state_dict(params_from_flax(weights))
    td, tp = model(torch.tensor(frames))
    for f in range(3):
        for s in range(4):
            np.testing.assert_allclose(td[f][s].detach().numpy(), np.asarray(jd[f][s]), atol=1e-4)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-4)
    tv = _outputs_scalar(td, tp, torch)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-4)
    tv.backward()
    jg = params_from_flax(flax.traverse_util.flatten_dict(jg, sep="/"))
    bad = {n: _rel(p.grad.numpy(), jg[n].numpy()) for n, p in model.named_parameters()}
    assert max(bad.values()) < 1e-3, {n: r for n, r in bad.items() if r >= 1e-3}


def _train_configs():
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width, cfg.data.batch_size = H, W, 2
    cfg.data.frame_offsets = (1,)
    cfg.data.augment = False
    return cfg


@pytest.fixture(scope="module")
def train_batch():
    seq = render_sequence(n_frames=6, height=H, width=W, seed=3)
    cfg = _train_configs()
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    return seq, to_device(next(batch_iterator(ds, cfg.data, seed=0)), torch.device("cpu"))


def test_exact_math_model_knobs_equal_the_default_in_port(train_batch):
    """model.remat, model.batched_snippet=false and loss.photo_remat
    compute the default's function: loss_fn from the same weights and
    batch to 1e-5, every parameter gradient to 1e-4 relative L2."""
    _, batch = train_batch
    runs = {}
    for name, section, knob, value in (("default", None, None, None),
                                       ("remat", "model", "remat", True),
                                       ("per_frame", "model", "batched_snippet", False),
                                       ("photo_remat", "loss", "photo_remat", True)):
        cfg = _train_configs()
        if section:
            setattr(getattr(cfg, section), knob, value)
        state = init_state(cfg, seed=3, device="cpu")
        loss, _ = loss_fn(state.model, batch, cfg)
        loss.backward()
        runs[name] = (loss.item(), {n: p.grad for n, p in state.model.named_parameters()})
    want_l, want_g = runs.pop("default")
    for name, (got_l, got_g) in runs.items():
        np.testing.assert_allclose(got_l, want_l, rtol=1e-5, err_msg=name)
        for n, g in want_g.items():
            assert _rel(got_g[n].numpy(), g.numpy()) < 1e-4, (name, n)


# ------------------------------------------------------- Adam's bf16 moment

@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_matches_optax(weight_decay, mu_dtype):
    """Three steps of the port's Adam (AdamW with weight decay) against
    optax's adam/adamw(mu_dtype=) on the same gradients: μ in ``mu_dtype``
    and bit-equal, ν float32 and the parameters within 1e-6 relative."""
    mu_t, mu_j = getattr(torch, mu_dtype), getattr(jnp, mu_dtype)
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = (optax.adamw(1e-3, weight_decay=weight_decay, mu_dtype=mu_j) if weight_decay
          else optax.adam(1e-3, mu_dtype=mu_j))
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = Adam(tp, lr=1e-3, weight_decay=weight_decay, mu_dtype=mu_t)
    for _ in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.tensor(x)
        opt.step()
    for i, t in enumerate(tp):
        st = opt.state[t]
        assert st["exp_avg"].dtype == mu_t and st["exp_avg_sq"].dtype == torch.float32
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(),
                                      np.asarray(jstate[0].mu[i]).astype(np.float32))
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jstate[0].nu[i]),
                                   rtol=1e-6)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[i]), rtol=1e-6)


def test_bf16_moment_through_checkpoints_and_the_chunk(train_batch, tmp_path):
    """Under adam_mu_dtype="bfloat16": two train steps, a checkpoint, a
    restore into a fresh state (μ stays bf16, bit for bit), one more step
    on each state equal bit for bit; and a make_scan_train chunk on the
    CPU, with model.remat and photo_remat as well, equal to eager steps on
    the same batch."""
    seq, batch = train_batch
    cfg = _train_configs()
    cfg.train.adam_mu_dtype = "bfloat16"
    state = init_state(cfg, seed=3, device="cpu")
    assert isinstance(state.optimizer, Adam)
    for _ in range(2):
        train_step(state, batch, cfg)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(2, state)
    ckpt.wait()
    fresh = init_state(cfg, seed=9, device="cpu")
    fresh, step = ckpt.restore(fresh)
    ckpt.close()
    assert step == 2
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        sa, sb = state.optimizer.state[a], fresh.optimizer.state[b]
        assert sb["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"],
                                                                         sb["exp_avg_sq"])
    m1, m2 = train_step(state, batch, cfg), train_step(fresh, batch, cfg)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                 fresh.model.parameters()))

    cfg.model.remat = cfg.loss.photo_remat = True
    store = DeviceSnippetStore([seq.frames[:2]], [seq.k], cfg.data.frame_offsets, device="cpu")
    chunked = init_state(cfg, seed=3, device="cpu")
    chunk = make_scan_train(chunked, cfg, 2)
    chunked, metrics = chunk(chunked, store.frames, store.table, store.k,
                             torch.Generator().manual_seed(1))
    snippet = gather(store.frames, store.table, torch.zeros(2, dtype=torch.int64))
    plain = init_state(cfg, seed=3, device="cpu")
    for i in range(2):
        m = train_step(plain, {"frames": snippet, "frames_clean": snippet, "k": store.k}, cfg)
        for k, v in m.items():
            np.testing.assert_allclose(metrics[k][i].item(), v.item(), rtol=1e-5, err_msg=k)
    for a, b in zip(chunked.model.parameters(), plain.model.parameters()):
        assert chunked.optimizer.state[a]["exp_avg"].dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------ train.deterministic

def test_deterministic_training_sets_and_restores_the_flags(tmp_path, train_batch):
    """train.deterministic=True on the CPU: the loop runs, with
    deterministic algorithms, cuDNN deterministic without autotuning, TF32
    off and CUBLAS_WORKSPACE_CONFIG set inside train; every flag is what it
    was after it returns. Two runs give the same weights bit for bit."""
    seq, _ = train_batch
    cfg = _train_configs()
    cfg.train.deterministic = True
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    seen = []

    def hook(step, state, writer):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))

    weights = []
    for run in range(2):
        cfg.train.ckpt_dir = str(tmp_path / f"ckpt{run}")
        model, _ = train_loop(cfg, ds, log_dir=str(tmp_path / f"log{run}"), max_steps=2,
                              eval_hook=hook, device="cpu")
        weights.append([p.detach().clone() for p in model.parameters()])
        after = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        assert after == before
    assert seen and all(s == (True, True, False, False, False, ":4096:8") for s in seen)
    assert all(torch.equal(a, b) for a, b in zip(*weights))
