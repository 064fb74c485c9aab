"""colvo_torch.losses against colvo.losses at float32 on the CPU: the
photometric/LCC functions, the loss terms, and snippet_loss (loss, aux
terms, gradients with respect to disparities and poses) on the default
path and under the alternative photometric paths ``loss.fused_kernel`` and
``loss.batched_photo``, which JAX runs on the CPU through its XLA
fallbacks."""

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
from colvo_torch.config import PORT_ONLY, ColvoConfig
from colvo_torch.data import render_sequence
from colvo_torch.losses import photometric as tphoto
from colvo_torch.losses import terms as tterms
from colvo_torch.losses.total import snippet_loss

torch.set_num_threads(2)

B, H, W = 2, 64, 96


def _t(a, grad=False, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


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


def _loss_inputs(seed=4, t_scale=1.0, exposure_jitter=0.0, dtype=np.float32):
    seq = render_sequence(n_frames=4, height=H, width=W, exposure_jitter=exposure_jitter)
    frames = np.stack([seq.frames[[1, 0, 2]], seq.frames[[2, 1, 3]]]).astype(dtype)
    rng = np.random.default_rng(seed)
    disps = [{s: rng.uniform(0.05, 0.6, (B, H >> s, W >> s, 1)).astype(dtype)
              for s in range(4)} for _ in range(3)]
    poses = np.concatenate([rng.normal(0, 0.01, (B, 2, 3)),
                            t_scale * rng.normal(0, 0.01, (B, 2, 3))], -1).astype(dtype)
    return disps, poses, frames, seq.k.astype(dtype)


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
    "batched_photo": {"loss": {"batched_photo": True}},
    "fused_kernel": {"loss": {"fused_kernel": True}},
    # the composed path of warp_photometric: its LCC pools no valid mask
    "fused_kernel_global_lcc": {"loss": {"fused_kernel": True, "lcc_mode": "global+affine"}},
}
KNOB_VARIANTS = ("batched_photo", "fused_kernel", "fused_kernel_global_lcc")


def _run_both(variant, with_grad, exposure_jitter=0.0, dtype=np.float32):
    spec = VARIANTS[variant] if isinstance(variant, str) else variant
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        for k, v in spec.get("loss", {}).items():
            setattr(cfg.loss, k, v)
    geo_scale = spec.get("geo_scale", 1.0)
    disps, poses, frames, k = _loss_inputs(t_scale=spec.get("t_scale", 1.0),
                                           exposure_jitter=exposure_jitter, dtype=dtype)
    k_inv = np.linalg.inv(k).astype(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    def jf(disps, poses):
        loss, aux = jax_snippet_loss(disps, poses, jnp.asarray(frames), k, k_inv,
                                     jcfg.loss, jcfg.model, geo_scale=geo_scale)
        return loss, aux

    tdisps = [{s: _t(v, with_grad, tdt) for s, v in d.items()} for d in disps]
    tposes = _t(poses, with_grad, tdt)
    tl, taux = snippet_loss(tdisps, tposes, _t(frames, dtype=tdt), _t(k, dtype=tdt),
                            _t(k_inv, dtype=tdt), tcfg.loss, tcfg.model, geo_scale=geo_scale)
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


def _check_with_gradients(variant, **inputs):
    (jl, jaux, gd, gp), (tl, taux, tdisps, tposes) = _run_both(variant, True, **inputs)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    for f in range(3):
        for s in range(4):
            assert _rel(tdisps[f][s].grad.numpy(), gd[f][s]) < 1e-3, (f, s)
    assert _rel(tposes.grad.numpy(), gp) < 1e-3


def test_snippet_loss_default_matches_with_gradients():
    """Default DCDP+LCC loss: value and every aux term ≤1e-4 relative, and
    the gradients to each frame's disparities at each scale and to the
    poses ≤1e-3 relative L2."""
    _check_with_gradients("default")


@pytest.mark.parametrize("variant", KNOB_VARIANTS)
def test_snippet_loss_photometric_knobs_match_with_gradients(variant):
    """The alternative photometric paths, at the default test's
    tolerances: the grouped sampler with one stats pipeline over the stack,
    the fused error (plain forward and analytic backward on the CPU), and
    the fused knob's composed path under global LCC."""
    _check_with_gradients(variant)


# snippet_loss on frames with ±35 % per-frame exposure gain: (loss knobs, dtype)
JITTER_CASES = {
    "lcc_off": ({"lcc": False}, np.float32),
    # In float32 the automask's near-ties (the packages' errors differ by
    # ~1e-5) reach 2.9e-2 of one scale's gradient under global+affine LCC;
    # in float64 both packages decide alike. The final reductions stay f32.
    "global_affine": ({"lcc_mode": "global+affine"}, np.float64),
}


@pytest.mark.parametrize("case", JITTER_CASES)
def test_snippet_loss_under_exposure_jitter_matches_with_gradients(case):
    """The loss on exposure-jittered frames (0.35), without LCC and under
    global+affine LCC, at the default test's tolerances; the float64 case
    runs the reference with 64-bit types enabled."""
    knobs, dtype = JITTER_CASES[case]
    if dtype == np.float64:
        with jax.enable_x64(True):
            _check_with_gradients({"loss": knobs}, exposure_jitter=0.35, dtype=dtype)
    else:
        _check_with_gradients({"loss": knobs}, exposure_jitter=0.35, dtype=dtype)


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "default"])
def test_snippet_loss_branches_match(variant):
    (jl, jaux), (tl, taux) = _run_both(variant, False)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    _check_aux(jaux, taux)
    if variant == "gauge_active":
        assert taux["loss/gauge"].item() > 0


def _port_loss(knobs, with_grad):
    cfg = ColvoConfig()
    for k, v in knobs.items():
        setattr(cfg.loss, k, v)
    disps, poses, frames, k = _loss_inputs()
    tdisps = [{s: _t(v, with_grad) for s, v in d.items()} for d in disps]
    tposes = _t(poses, with_grad)
    loss, aux = snippet_loss(tdisps, tposes, _t(frames), _t(k), _t(np.linalg.inv(k)), cfg.loss,
                             cfg.model)
    if with_grad:
        loss.backward()
    return loss, aux, [d[s].grad for d in tdisps for s in d] + [tposes.grad]


@pytest.mark.parametrize("knob,base", [
    ("batched_photo", {}), ("batched_photo", {"lcc_mode": "global+affine"}),
    ("fused_kernel", {}), ("fused_kernel", {"lcc": False}),
])
def test_photometric_knobs_equal_default_in_port(knob, base):
    """Each knob computes the default path's function on the same inputs:
    loss and aux ≤1e-5 relative, gradients ≤1e-4 relative L2. (Under
    global LCC fused_kernel differs by design: its composed path pools no
    valid mask; the JAX comparison above pins that.)"""
    want_l, want_aux, want_g = _port_loss(base, True)
    got_l, got_aux, got_g = _port_loss({**base, knob: True}, True)
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=1e-5)
    for key, v in want_aux.items():
        np.testing.assert_allclose(got_aux[key].detach().numpy(), v.detach().numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=key)
    for got, want in zip(got_g, want_g):
        assert _rel(got.numpy(), want.numpy()) < 1e-4


@pytest.mark.parametrize("geo_res_cap", [0, 32])
def test_multi_scale_geo_pass_equals_per_scale_plain_samplers(monkeypatch, geo_res_cap):
    """The loss's one multi-scale geo call equals a sampler called scale by
    scale: geometry.ops.bilinear_sample under torch autograd (gradients to
    the source depth and the coordinates). loss/geometric and the loss
    ≤1e-6 relative, gradients ≤1e-5 relative L2; with geo_res_cap=32 two
    plane sets share a shape."""
    from colvo_torch.geometry.ops import bilinear_sample
    from colvo_torch.losses import total

    knobs = {"geo_res_cap": geo_res_cap}
    want_l, want_aux, want_g = _port_loss(knobs, True)
    calls = []

    def per_scale(srcs, xs, ys):
        calls.append(len(srcs))
        return [bilinear_sample(src.permute(0, 2, 3, 1), torch.stack([x, y], -1))
                .permute(0, 3, 1, 2) for src, x, y in zip(srcs, xs, ys)]

    monkeypatch.setattr(total, "bilinear_sample_full_multi", per_scale)
    got_l, got_aux, got_g = _port_loss(knobs, True)
    assert calls == [4]
    np.testing.assert_allclose(got_aux["loss/geometric"].item(),
                               want_aux["loss/geometric"].item(), rtol=1e-6)
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=1e-6)
    for got, want in zip(got_g, want_g):
        assert _rel(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("knobs,match", [
    ({"fused_kernel": True, "batched_photo": True}, "batched_photo"),
    ({"fused_kernel": True, "compute_dtype": "bfloat16"}, "compute_dtype"),
    ({"fused_kernel": True, "batched_photo": True, "compute_dtype": "bfloat16"}, "batched_photo"),
])
def test_conflicting_photometric_knobs_raise_the_reference_error(knobs, match):
    """The reference's ValueErrors, in its order."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        for k, v in knobs.items():
            setattr(cfg.loss, k, v)
    disps, poses, frames, k = _loss_inputs()
    k_inv = np.linalg.inv(k).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        jax_snippet_loss(disps, poses, jnp.asarray(frames), k, k_inv, jcfg.loss, jcfg.model)
    with pytest.raises(ValueError, match=match):
        snippet_loss([{s: _t(v) for s, v in d.items()} for d in disps], _t(poses), _t(frames),
                     _t(k), _t(k_inv), tcfg.loss, tcfg.model)


@pytest.mark.parametrize("knobs,match", [
    ({"geo_grad": "sym", "geo_full_res": True}, "native-scale protocol"),
    ({"photo_native": True, "geo_full_res": True}, "contradicts"),
    ({"photo_native": True, "batched_photo": True}, "incompatible with loss.photo_native"),
    # refused for its first conflict, in the reference's order
    ({"photo_native": True, "geo_full_res": True, "batched_photo": True}, "contradicts"),
    ({"compute_dtype": "half"}, "compute_dtype must be"),
    ({"compute_dtype": "float16"}, "compute_dtype must be"),
])
def test_unported_loss_knobs_raise(knobs, match):
    """Every loss knob is ported; the combinations the reference does not
    define raise its ValueError in both packages (a knob value outside the
    reference's set too)."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for cfg in (jcfg, tcfg):
        for k, v in knobs.items():
            setattr(cfg.loss, k, v)
    disps, poses, frames, k = _loss_inputs()
    k_inv = np.linalg.inv(k).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        jax_snippet_loss(disps, poses, jnp.asarray(frames), k, k_inv, jcfg.loss, jcfg.model)
    with pytest.raises(ValueError, match=match):
        snippet_loss([{s: _t(v) for s, v in d.items()} for d in disps], _t(poses), _t(frames),
                     _t(k), _t(k_inv), tcfg.loss, tcfg.model)


def test_config_defaults_mirror_reference():
    """Every knob of the reference config exists in the port with the same
    default, and overrides parse the same way; the port's own knobs are
    exactly those ``PORT_ONLY`` names, and left out of the comparison."""
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    assert tcfg.shared_dict() == jcfg.to_dict()
    ov = ["loss.lcc_mode=global", "data.frame_offsets=[-2,2]", "--train.lr=2e-4"]
    assert tcfg.apply_overrides(ov).shared_dict() == jcfg.apply_overrides(ov).to_dict()
    assert ColvoConfig.from_dict(jcfg.to_dict()).shared_dict() == jcfg.to_dict()
    port, ref = dataclasses.asdict(ColvoConfig()), jcfg.to_dict()
    assert {f"{s}.{k}" for s in port for k in port[s] if k not in ref[s]} == set(PORT_ONLY)
