"""colvo_torch.losses against colvo.losses at float32 on the CPU: the
photometric/LCC functions, the loss terms, and snippet_loss (loss, aux
terms, gradients with respect to disparities and poses)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvo.config import ColvoConfig as JaxConfig
from colvo.losses import photometric as jphoto
from colvo.losses import terms as jterms
from colvo.losses.total import snippet_loss as jax_snippet_loss
from colvo_torch.config import ColvoConfig
from colvo_torch.data import render_sequence
from colvo_torch.losses import photometric as tphoto
from colvo_torch.losses import terms as tterms
from colvo_torch.losses.total import snippet_loss

torch.set_num_threads(2)

B, H, W = 2, 64, 96


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / (np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def images():
    seq = render_sequence(n_frames=3, height=H, width=W, exposure_jitter=0.2)
    rng = np.random.default_rng(0)
    warped = np.clip(seq.frames[1:3] + rng.normal(0, 0.02, (2, H, W, 3)), 0, 1).astype(np.float32)
    return warped, seq.frames[:2], seq.frames


@pytest.mark.parametrize("mode", ["off", "gain", "affine", "global", "global+affine", "global+gain"])
@pytest.mark.parametrize("masked", [False, True])
def test_lcc_photometric_matches(images, mode, masked):
    """lcc_calibrate (all modes, valid-masked global moments) followed by
    photometric_error: values and the gradient to the warped frame, which
    must see the stop-gradients on the coefficients."""
    warped, target, _ = images
    mask = (np.random.default_rng(1).random((2, H, W)) > 0.2).astype(np.float32) if masked else None

    def jf(w):
        cal = jphoto.lcc_calibrate(w, target, mode, 15, valid_mask=mask)
        return jphoto.photometric_error(cal, target, 0.85)

    ref = jf(jnp.asarray(warped))
    tw = _t(warped, True)
    out = tphoto.photometric_error(
        tphoto.lcc_calibrate(tw, _t(target), mode, 15,
                             valid_mask=None if mask is None else _t(mask)),
        _t(target), 0.85)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    g = jax.grad(lambda w: jnp.sum(jf(w) ** 2))(jnp.asarray(warped))
    torch.sum(out**2).backward()
    assert _rel(tw.grad.numpy(), g) < 1e-4


@pytest.mark.parametrize("window", [3, 4])
def test_ssim_matches(images, window):
    """Raw SSIM, odd and even (asymmetrically padded) windows. atol 2e-4:
    σ = E[x²] − μ² cancels in float32, and both packages land ~5e-5..9e-5
    from a float64 evaluation, in opposite directions."""
    warped, target, _ = images
    np.testing.assert_allclose(
        tphoto.ssim(_t(warped), _t(target), window=window).numpy(),
        np.asarray(jphoto.ssim(warped, target, window=window)), atol=2e-4)


@pytest.mark.parametrize("behind_frac", [0.0, 0.02, 0.2])
def test_geometry_consistency_matches(behind_frac):
    """The behind-camera rule at both sides of its 5 % gate, values and
    gradients to both depths (finite where z ≤ 0)."""
    rng = np.random.default_rng(2)
    z = rng.uniform(0.05, 1.0, (2, 16, 24)).astype(np.float32)
    z[rng.random(z.shape) < behind_frac] *= -1
    s = rng.uniform(0.05, 1.0, z.shape).astype(np.float32)
    valid = (rng.random(z.shape) > 0.1).astype(np.float32)

    def jf(z, s):
        return jterms.geometry_consistency(z, s, valid, behind=z <= 0)

    jl, jw = jf(z, s)
    tz, ts = _t(z, True), _t(s, True)
    tl, tw = tterms.geometry_consistency(tz, ts, _t(valid), behind=tz <= 0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), atol=1e-6)
    gz, gs = jax.grad(lambda z, s: jf(z, s)[0] + jnp.sum(jf(z, s)[1] ** 2), argnums=(0, 1))(z, s)
    (tl + torch.sum(tw**2)).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=1e-4, atol=1e-7)


def test_smoothness_automask_minreproj_match(images):
    _, target, _ = images
    rng = np.random.default_rng(3)
    disp = rng.uniform(0.05, 0.95, (2, H, W, 1)).astype(np.float32)
    td = _t(disp, True)
    ts = tterms.smoothness_loss(td, _t(target))
    np.testing.assert_allclose(ts.item(), float(jterms.smoothness_loss(disp, target)), rtol=1e-5)
    ts.backward()
    gd = jax.grad(lambda d: jterms.smoothness_loss(d, target))(disp)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=1e-4, atol=1e-9)

    errs = rng.random((2, 8, 8, 2)).astype(np.float32)
    errs[0, 0, 0] = [0.3, 0.3]  # a tie: the gradient splits evenly
    ident = rng.random((2, 8, 8, 2)).astype(np.float32)
    te = _t(errs, True)
    tmin, tmask = tterms.automask(te, _t(ident))
    jmin, jmask = jterms.automask(errs, ident)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    (tmin * tmask).sum().backward()
    ge = jax.grad(lambda e: jnp.sum(jterms.automask(e, ident)[0] * jmask))(errs)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), atol=1e-7)
    np.testing.assert_allclose(tterms.min_reprojection(_t(errs)).numpy(),
                               np.asarray(jterms.min_reprojection(errs)))


def _loss_inputs(seed=4, t_scale=1.0):
    seq = render_sequence(n_frames=4, height=H, width=W)
    frames = np.stack([seq.frames[[1, 0, 2]], seq.frames[[2, 1, 3]]]).astype(np.float32)
    rng = np.random.default_rng(seed)
    disps = [{s: rng.uniform(0.05, 0.6, (B, H >> s, W >> s, 1)).astype(np.float32)
              for s in range(4)} for _ in range(3)]
    poses = np.concatenate([rng.normal(0, 0.01, (B, 2, 3)),
                            t_scale * rng.normal(0, 0.01, (B, 2, 3))], -1).astype(np.float32)
    return disps, poses, frames, seq.k


VARIANTS = {
    "default": {},
    "gauge_active": {"t_scale": 30.0},
    "min_reprojection": {"loss": {"automask": False}},
    "lcc_global_identity_geo_cap_ramp": {
        "loss": {"lcc_mode": "global+affine", "lcc_identity": True, "geo_res_cap": 32},
        "geo_scale": 0.25,
    },
    "mean_no_geo_no_lcc": {"loss": {
        "automask": False, "min_reprojection": False, "geometric_weight": 0.0,
        "lcc": False, "gauge_weight": 0.0,
    }},
}


def _run_both(variant, with_grad):
    spec = VARIANTS[variant]
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        for k, v in spec.get("loss", {}).items():
            setattr(cfg.loss, k, v)
    geo_scale = spec.get("geo_scale", 1.0)
    disps, poses, frames, k = _loss_inputs(t_scale=spec.get("t_scale", 1.0))
    k_inv = np.linalg.inv(k).astype(np.float32)

    def jf(disps, poses):
        loss, aux = jax_snippet_loss(disps, poses, jnp.asarray(frames), k, k_inv,
                                     jcfg.loss, jcfg.model, geo_scale=geo_scale)
        return loss, aux

    tdisps = [{s: _t(v, with_grad) for s, v in d.items()} for d in disps]
    tposes = _t(poses, with_grad)
    tl, taux = snippet_loss(tdisps, tposes, _t(frames), _t(k), _t(k_inv), tcfg.loss,
                            tcfg.model, geo_scale=geo_scale)
    if with_grad:
        (jl, jaux), (gd, gp) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
            disps, poses)
        tl.backward()
        return (jl, jaux, gd, gp), (tl, taux, tdisps, tposes)
    jl, jaux = jax.jit(jf)(disps, poses)
    return (jl, jaux), (tl, taux)


def _check_aux(jaux, taux):
    assert sorted(jaux) == sorted(taux)
    for key in jaux:
        want, got = np.asarray(jaux[key]), taux[key].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7, err_msg=key)


def test_snippet_loss_default_matches_with_gradients():
    """Default DCDP+LCC loss: value and every aux term ≤1e-4 relative, and
    the gradients to each frame's disparities at each scale and to the
    poses ≤1e-3 relative L2."""
    (jl, jaux, gd, gp), (tl, taux, tdisps, tposes) = _run_both("default", True)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    for f in range(3):
        for s in range(4):
            assert _rel(tdisps[f][s].grad.numpy(), gd[f][s]) < 1e-3, (f, s)
    assert _rel(tposes.grad.numpy(), gp) < 1e-3


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "default"])
def test_snippet_loss_branches_match(variant):
    (jl, jaux), (tl, taux) = _run_both(variant, False)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    if variant == "gauge_active":
        assert taux["loss/gauge"].item() > 0


@pytest.mark.parametrize("knob,value", [
    ("batched_photo", True), ("fused_kernel", True), ("photo_native", True),
    ("geo_full_res", True), ("geo_grad", "sym"), ("geo_stopgrad", True),
    ("compute_dtype", "bfloat16"), ("photo_remat", True), ("scatter_audit", True),
])
def test_unported_loss_knobs_raise(knob, value):
    cfg = ColvoConfig()
    setattr(cfg.loss, knob, value)
    disps, poses, frames, k = _loss_inputs()
    with pytest.raises(NotImplementedError, match=f"loss.{knob}"):
        snippet_loss([{s: _t(v) for s, v in d.items()} for d in disps], _t(poses), _t(frames),
                     _t(k), _t(np.linalg.inv(k)), cfg.loss, cfg.model)


def test_config_defaults_mirror_reference():
    """Every knob of the reference config exists in the port with the same
    default, and overrides parse the same way."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    assert tcfg.to_dict() == jcfg.to_dict()
    ov = ["loss.lcc_mode=global", "data.frame_offsets=[-2,2]", "--train.lr=2e-4"]
    assert tcfg.apply_overrides(ov).to_dict() == jcfg.apply_overrides(ov).to_dict()
    assert dataclasses.asdict(ColvoConfig.from_dict(jcfg.to_dict())) == jcfg.to_dict()
