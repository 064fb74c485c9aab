"""colvo_torch's off-default loss protocols against colvo's on the CPU:
``photo_native`` (with ``photo_remat``, ``geo_res_cap=64``,
``fused_kernel`` and without the automask), ``geo_full_res`` (with
``geo_stopgrad``), ``geo_stopgrad``, ``geo_grad="sym"``, ``photo_remat``
and ``scatter_audit``, at ``test_torch_port_losses.py``'s tolerances (loss
and aux ≤1e-4 relative, disparity and pose gradients ≤1e-3 relative L2),
with the reference's automask decisions shared as
``test_torch_port_train_step.py`` does; ``photo_remat`` against the port
without it; and the reference's refusals of Adam moment dtypes it does
not define, from both packages (its loss refusals:
``test_torch_port_losses.py::test_unported_loss_knobs_raise``). ``test_torch_port_knobs_train.py``
holds the bf16 planes, the pooled geo grid, the model and train knobs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colvo.losses.total as jax_total
import colvo_torch.losses.total as port_total
from colvo.config import ColvoConfig as JaxConfig
from colvo.losses.total import snippet_loss as jax_snippet_loss
from colvo.runtime.train_step import make_optimizer
from colvo_torch.config import ColvoConfig
from colvo_torch.losses.total import snippet_loss
from colvo_torch.runtime import init_state
from test_torch_port_losses import _check_aux, _loss_inputs, _rel, _t
from test_torch_port_train_step import SharedAutomask

torch.set_num_threads(2)

# Loss knobs held against colvo with gradients, at the f32 tolerances.
LOSS_KNOBS = {
    "photo_native": {"photo_native": True},
    "photo_native_remat": {"photo_native": True, "photo_remat": True},
    "photo_native_cap64": {"photo_native": True, "geo_res_cap": 64},
    "photo_native_fused": {"photo_native": True, "fused_kernel": True},
    "photo_native_no_automask": {"photo_native": True, "automask": False},
    "geo_full_res": {"geo_full_res": True},
    "geo_full_res_stopgrad": {"geo_full_res": True, "geo_stopgrad": True},
    "geo_stopgrad": {"geo_stopgrad": True},
    "geo_grad_sym": {"geo_grad": "sym"},
    "photo_remat": {"photo_remat": True},
    "scatter_audit": {"scatter_audit": True},
}


def _loss_both(knobs, seed=4):
    """The same inputs through both packages' snippet_loss with ``knobs``:
    (reference loss, aux, disparity grads, pose grads), (port loss, aux,
    disparity leaves, pose leaf) after the port's backward."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        for k, v in knobs.items():
            setattr(cfg.loss, k, v)
    disps, poses, frames, k = _loss_inputs(seed)
    k_inv = np.linalg.inv(k).astype(np.float32)

    def jf(d, p):
        return jax_snippet_loss(d, p, jnp.asarray(frames), k, k_inv, jcfg.loss, jcfg.model)

    (jl, jaux), (gd, gp) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        disps, poses)
    jax.effects_barrier()  # a SharedAutomask has recorded the reference's masks
    tdisps = [{s: _t(v, True) for s, v in d.items()} for d in disps]
    tposes = _t(poses, True)
    tl, taux = snippet_loss(tdisps, tposes, _t(frames), _t(k), _t(k_inv), tcfg.loss, tcfg.model)
    tl.backward()
    return (jl, jaux, gd, gp), (tl, taux, tdisps, tposes)


@pytest.mark.parametrize("variant", list(LOSS_KNOBS))
def test_loss_knobs_match_the_reference_with_gradients(variant, monkeypatch):
    """Each knob's loss, every aux term (the audit's zero included) and the
    gradients to every frame's disparity at every scale and to the poses,
    against colvo's on the same inputs. The port takes the reference's
    automask decisions, and its own may differ from them only at near-ties
    (``SharedAutomask`` of test_torch_port_train_step.py)."""
    shared = SharedAutomask(4)
    monkeypatch.setattr(jax_total, "automask_fn", shared.jax_automask)
    monkeypatch.setattr(port_total, "automask_fn", shared.port_automask)
    (jl, jaux, gd, gp), (tl, taux, tdisps, tposes) = _loss_both(LOSS_KNOBS[variant])
    shared.check_port_decisions()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    for f in range(3):
        for s in range(4):
            got = tdisps[f][s].grad  # None where no gradient reaches (the reference's zeros)
            got = np.zeros_like(gd[f][s]) if got is None else got.numpy()
            assert _rel(got, gd[f][s]) < 1e-3, (f, s)
    assert _rel(tposes.grad.numpy(), gp) < 1e-3
    if variant == "scatter_audit":
        assert "geo/scatter_overflow" in taux
        assert taux["geo/scatter_overflow"].dtype == torch.float32
        assert taux["geo/scatter_overflow"].item() == float(jaux["geo/scatter_overflow"]) == 0


def _port_loss(knobs, seed=4, with_grad=True):
    cfg = ColvoConfig()
    for k, v in knobs.items():
        setattr(cfg.loss, k, v)
    disps, poses, frames, k = _loss_inputs(seed)
    tdisps = [{s: _t(v, with_grad) for s, v in d.items()} for d in disps]
    tposes = _t(poses, with_grad)
    loss, aux = snippet_loss(tdisps, tposes, _t(frames), _t(k), _t(np.linalg.inv(k)), cfg.loss,
                             cfg.model)
    if with_grad:
        loss.backward()
    return loss, aux, [d[s].grad for d in tdisps for s in d], tposes.grad


def test_photo_remat_equals_no_remat_in_port():
    """photo_remat recomputes the same function: loss ≤1e-5, gradients
    ≤1e-4 relative L2, with and without photo_native."""
    for base in ({}, {"photo_native": True}):
        want_l, _, want_gd, want_gp = _port_loss(base)
        got_l, _, got_gd, got_gp = _port_loss({**base, "photo_remat": True})
        np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=1e-5)
        for got, want in zip(got_gd + [got_gp], want_gd + [want_gp]):
            assert _rel(got.numpy(), want.numpy()) < 1e-4


@pytest.mark.parametrize("value", ["float16", "half"])
def test_refused_adam_mu_dtype_raises_in_both_packages(value):
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    jcfg.train.adam_mu_dtype = tcfg.train.adam_mu_dtype = value
    with pytest.raises(ValueError, match="adam_mu_dtype must be"):
        make_optimizer(jcfg)
    with pytest.raises(ValueError, match="adam_mu_dtype must be"):
        init_state(tcfg, device="cpu")


