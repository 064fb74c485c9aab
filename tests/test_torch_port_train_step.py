"""colvo_torch.runtime.train_step against colvo.runtime.train_step at
float32 on the CPU: per-parameter gradients of the default loss with the
same weights and batch, and three clipped Adam steps.

The automask keep-mask is a threshold decision per pixel (warped error <
identity error + 1e-5). SSIM's variance cancellation leaves the two
packages' float32 errors ~1e-5 apart, so a pixel that close to the
threshold can decide differently, and at this size one such pixel at the
coarsest scale moves a parameter gradient by ~3e-3 of its norm. The
gradient comparisons therefore give the port the reference's decisions
(``SharedAutomask``) and hold the port's own decisions to agree everywhere
but at such near-ties.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import colvo.losses.total as jax_total
import colvo_torch.losses.total as port_total
from colvo.config import ColvoConfig as JaxConfig
from colvo.losses import snippet_loss as jax_snippet_loss
from colvo.models import ColVOModel as JaxModel
from colvo.runtime.train_step import make_optimizer
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
from colvo_torch.runtime import (
    clip_by_global_norm,
    flax_params,
    init_state,
    learning_rate,
    loss_fn,
    params_from_flax,
    to_device,
    train_step,
)

torch.set_num_threads(2)

# A port decision may differ from the reference's only this close to the
# automask threshold, and on at most this share of the pixels.
NEAR_TIE, MAX_FLIP_SHARE = 1e-4, 1e-3


class SharedAutomask:
    """Patches both packages' automask: the reference's records its keep-
    masks (by scale, through ``jax.debug.callback`` so it works under
    ``jit``), and the port's returns them in place of its own, noting the
    threshold gap of every pixel where its own decision differs."""

    def __init__(self, n_scales: int):
        self.n_scales = n_scales
        self.masks = {}
        self.jax_calls = self.port_calls = self.decisions = 0
        self.flip_gaps = []
        self._jax_fn, self._port_fn = jax_total.automask_fn, port_total.automask_fn

    def _store(self, scale, mask):
        self.masks[scale] = np.asarray(mask)

    def jax_automask(self, errors, identity):
        min_err, mask = self._jax_fn(errors, identity)
        scale = self.jax_calls % self.n_scales  # runs once per scale, at trace time
        self.jax_calls += 1
        jax.debug.callback(functools.partial(self._store, scale), mask)
        return min_err, mask

    def port_automask(self, errors, identity):
        min_err, mask = self._port_fn(errors, identity)
        scale = self.port_calls % self.n_scales
        self.port_calls += 1
        ref = self.masks.pop(scale)
        gap = (min_err - torch.amin(identity, dim=-1) - 1e-5).detach().numpy()
        self.flip_gaps.extend(gap[mask.numpy() != ref].tolist())
        self.decisions += ref.size
        return min_err, torch.tensor(ref, dtype=mask.dtype)

    def check_port_decisions(self):
        gaps = np.abs(np.asarray(self.flip_gaps))
        assert np.all(gaps < NEAR_TIE), gaps.max()
        assert len(gaps) <= MAX_FLIP_SHARE * self.decisions, (len(gaps), self.decisions)


def _configs():
    cfgs = JaxConfig(), ColvoConfig()
    for cfg in cfgs:
        cfg.model.dtype = "float32"
        cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
        cfg.data.augment = False
        # clipping active and a geo ramp, so both are exercised
        cfg.train.lr, cfg.train.grad_clip, cfg.loss.geo_ramp_steps = 1e-4, 0.1, 2
    return cfgs


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    shared = SharedAutomask(tcfg.model.n_scales)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_total, "automask_fn", shared.jax_automask)
        mp.setattr(port_total, "automask_fn", shared.port_automask)
        yield _setup(jcfg, tcfg) + (shared,)


def _setup(jcfg, tcfg):
    seq = render_sequence(n_frames=6, height=64, width=96)
    ds = SnippetDataset([seq.frames], [seq.k], tcfg.data.frame_offsets)
    batch = next(batch_iterator(ds, tcfg.data, seed=0))
    state = init_state(tcfg, seed=3, device="cpu")
    flat = flax_params(state.model.state_dict())
    jparams = flax.traverse_util.unflatten_dict(flat, sep="/")
    model = JaxModel(jcfg.model)

    def jloss(params, geo_scale):
        disps, poses = model.apply(params, jnp.asarray(batch["frames"]))
        k = jnp.asarray(batch["k"])
        loss, aux = jax_snippet_loss(disps, poses, jnp.asarray(batch["frames"]), k,
                                     jnp.linalg.inv(k), jcfg.loss, jcfg.model,
                                     frames_clean=jnp.asarray(batch["frames_clean"]),
                                     geo_scale=geo_scale)
        aux.pop("depth/full")
        return loss, aux

    jit_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))

    def grad_fn(params, geo_scale):
        out = jit_grad(params, geo_scale)
        jax.effects_barrier()  # the automask masks have been recorded
        return out

    return jcfg, tcfg, batch, state, jparams, grad_fn


def test_gradients_match_per_parameter(setup):
    """Every parameter's gradient agrees to 1e-3 relative L2."""
    jcfg, tcfg, batch, state, jparams, grad_fn, shared = setup
    (jl, _), jg = grad_fn(jparams, 1.0)
    jg = params_from_flax(flax.traverse_util.flatten_dict(jg, sep="/"))
    model = state.model
    model.zero_grad()
    loss, _ = loss_fn(model, to_device(batch, torch.device("cpu")), tcfg, 1.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    bad = {}
    for name, p in model.named_parameters():
        ref = jg[name]
        rel = (p.grad - ref).norm().item() / max(ref.norm().item(), 1e-12)
        if rel > 1e-3:
            bad[name] = rel
    assert not bad, bad
    model.zero_grad()
    shared.check_port_decisions()


def _flax_tree(named_tensors):
    return flax.traverse_util.unflatten_dict(flax_params(dict(named_tensors)), sep="/")


def test_three_adam_steps_track_reference(setup):
    """Three train_step calls (clip → Adam, geo ramp 0.5 → 1), from the
    port's weights at each step: the loss, every aux term and grad_norm
    agree ≤1e-3 relative with the reference's at the same weights, and the
    port's parameter update is optax's clip+Adam update of the port's own
    gradients to 1e-3 of the learning rate.

    Trajectories are held step by step, not run apart: Adam's first steps
    move every weight by about ±lr whatever its gradient's size, so weights
    whose gradients sit at float32 noise move apart and the two runs
    diverge by percents within three steps at this size."""
    jcfg, tcfg, batch, state, _, grad_fn, shared = setup
    tx = make_optimizer(jcfg)
    model = state.model
    opt_state = tx.init(_flax_tree(model.state_dict()))
    update = jax.jit(tx.update)
    tbatch = to_device(batch, torch.device("cpu"))
    for step in range(3):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        geo = min(1.0, (step + 1.0) / jcfg.loss.geo_ramp_steps)
        (jl, jaux), jgrads = grad_fn(_flax_tree(before), geo)
        m = train_step(state, tbatch, tcfg)
        np.testing.assert_allclose(m["loss/total"].item(), float(jl), rtol=1e-3, err_msg=str(step))
        np.testing.assert_allclose(m["grad_norm"].item(), float(optax.global_norm(jgrads)),
                                   rtol=1e-3, err_msg=str(step))
        for k, v in jaux.items():
            np.testing.assert_allclose(m[k].item(), float(v), rtol=1e-3, atol=1e-7, err_msg=k)
        # train_step leaves the clipped gradients in .grad: undo the clip
        norm = m["grad_norm"].item()
        assert norm > tcfg.train.grad_clip  # the clip is active at every step
        grads = {n: p.grad * (norm / tcfg.train.grad_clip) for n, p in model.named_parameters()}
        updates, opt_state = update(_flax_tree(grads), opt_state)
        want = params_from_flax(flax.traverse_util.flatten_dict(updates, sep="/"))
        for name, p in model.named_parameters():
            np.testing.assert_allclose((p.detach() - before[name]).numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-3 * tcfg.train.lr, err_msg=name)
    assert state.step == 3
    shared.check_port_decisions()


@pytest.mark.parametrize("warmup,step", [(0, 0), (0, 14_999), (0, 15_000), (10, 3), (10, 10),
                                         (10, 15_010)])
def test_learning_rate_matches_optax_schedule(warmup, step):
    """The schedule colvo's make_optimizer builds: step decay ×0.1 from
    epoch 15 (1000 steps an epoch), behind an optional linear warmup."""
    cfg = ColvoConfig()
    cfg.train.warmup_steps = warmup
    sched = optax.piecewise_constant_schedule(1e-4, {15_000: 0.1})
    if warmup:
        sched = optax.join_schedules([optax.linear_schedule(0.0, 1e-4, warmup), sched], [warmup])
    np.testing.assert_allclose(learning_rate(cfg, step), float(sched(step)), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 1.0, 100.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(9)
    grads = [rng.normal(0, scale, s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in grads], None)
    tg = [torch.tensor(g) for g in grads]
    norm = clip_by_global_norm(tg, 10.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(tg, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_entry_points_need_a_card_unless_told_cpu():
    cfg = ColvoConfig()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)
    cfg.train.adam_mu_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="adam_mu_dtype"):
        init_state(cfg, device="cpu")
