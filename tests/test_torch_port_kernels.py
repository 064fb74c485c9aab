"""colvo_torch.kernels against the Pallas kernels of colvo.kernels (run in
interpret mode on the CPU, as tests/test_kernels.py does): the plain
versions behind the CPU path of the samplers (plain, grouped, full
gradient), value, coordinate gradient and source gradient, with
out-of-bounds and ±1e20 coords, the full-gradient sampler also over
several plane sets in one call, and of the fused photometric error and its
analytic coordinate backward. The CUDA kernels themselves run only on a
card (test_torch_port_cuda.py, and chip_smoke.py at the training
shapes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from colvo.geometry.ops import bilinear_sample as jax_bilinear_sample
from colvo.kernels.fused_loss import warp_photometric_pallas
from colvo.kernels.sampler import bilinear_sample_pallas, bilinear_sample_pallas_grouped
from colvo.kernels.scatter import bilinear_sample_fullgrad
from colvo.losses.photometric import lcc_calibrate as jax_lcc_calibrate
from colvo.losses.photometric import photometric_error as jax_photometric_error
from colvo_torch import kernels
from colvo_torch.kernels import build, fused_loss, lcc, project, sampler, scatter
from colvo_torch.losses.photometric import warp_photometric

torch.set_num_threads(2)

CASES = {
    "smooth": (1.5, False),
    "out_of_bounds": (20.0, False),
    "huge": (1.5, True),
}


def _coords(b, h, w, seed, scale, huge):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x = gx[None] + rng.normal(0, scale, (b, h, w)).astype(np.float32) + 0.3
    y = gy[None] + rng.normal(0, scale, (b, h, w)).astype(np.float32) + 0.3
    if huge:  # far right/left/below/above, and past int32 range
        x[0, 1, 3], x[0, 2, 5], x[1, 5, 11] = 1e20, -1e20, 3e9
        y[0, 3, 7], y[0, 4, 9] = 1e20, -1e20
    return np.stack([x, y], -1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


@pytest.mark.parametrize("case", list(CASES))
def test_coords_grad_sampler_matches_pallas(case):
    """bilinear_sample_fast (P1/P2 port) vs bilinear_sample_pallas: value,
    coords gradient, and no image gradient."""
    scale, huge = CASES[case]
    rng = np.random.default_rng(1)
    img = rng.random((2, 8, 128, 3), dtype=np.float32)
    coords = _coords(2, 8, 128, 2, scale, huge)
    loss = lambda i, c: jnp.sum(jnp.cos(3 * bilinear_sample_pallas(i, c)))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = bilinear_sample_pallas(jnp.asarray(img), jnp.asarray(coords))
        gi, gc = jax.grad(loss, argnums=(0, 1))(img, coords)
    ti, tc = _t(img, True), _t(coords, True)
    out = kernels.bilinear_sample_fast(ti, tc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    torch.sum(torch.cos(3 * out)).backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-4)
    assert ti.grad is None and not np.asarray(gi).any()
    # without autograd the value-only variant gives the same samples
    with torch.no_grad():
        np.testing.assert_allclose(
            kernels.bilinear_sample_fast(_t(img), _t(coords)).numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("case,h,w,c", [
    ("smooth", 16, 128, 1), ("smooth", 16, 40, 2), ("out_of_bounds", 16, 128, 1),
    ("huge", 16, 128, 1),
])
def test_full_grad_sampler_matches_pallas(case, h, w, c):
    """bilinear_sample_full (P3/P4 + scatter P5 port) vs
    bilinear_sample_fullgrad: value, source gradient, coords gradient."""
    scale, huge = CASES[case]
    rng = np.random.default_rng(3)
    img = rng.random((2, h, w, c), dtype=np.float32)
    coords = _coords(2, h, w, 4, scale, huge)
    loss = lambda i, cr: jnp.sum(jnp.cos(3 * bilinear_sample_fullgrad(i, cr)))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = bilinear_sample_fullgrad(jnp.asarray(img), jnp.asarray(coords))
        gi, gc = jax.grad(loss, argnums=(0, 1))(img, coords)
    ti, tc = _t(img, True), _t(coords, True)
    out = kernels.bilinear_sample_full(ti, tc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    torch.sum(torch.cos(3 * out)).backward()
    # atol 1e-4 on the source gradient: the scatter sums up to a few dozen
    # taps per source pixel, in another order than the reference's
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-4)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-4)


# (h, w) of the plane sets of one multi-scale call; 30 is no multiple of 4
MULTI_SCALES = ((16, 128), (16, 40), (8, 30))


@pytest.mark.parametrize("case", list(CASES))
def test_full_grad_multi_sampler_matches_pallas(case):
    """bilinear_sample_full_multi (P3/P4 + scatter P5, one call over
    plane sets of three shapes) vs bilinear_sample_fullgrad per plane set:
    value ≤1e-5, source and coords gradients ≤1e-4 abs of Σ cos(3·out)
    over all sets."""
    scale, huge = CASES[case]
    rng = np.random.default_rng(12)
    imgs = [rng.random((2, h, w, 1), dtype=np.float32) for h, w in MULTI_SCALES]
    coords = [_coords(2, h, w, 13 + i, scale, huge) for i, (h, w) in enumerate(MULTI_SCALES)]
    loss = lambda i, cr: jnp.sum(jnp.cos(3 * bilinear_sample_fullgrad(i, cr)))  # noqa: E731
    refs = []
    with pltpu.force_tpu_interpret_mode():
        for img, crd in zip(imgs, coords):
            refs.append((bilinear_sample_fullgrad(jnp.asarray(img), jnp.asarray(crd)),
                         *jax.grad(loss, argnums=(0, 1))(img, crd)))
    tis = [_t(img, True) for img in imgs]
    tcs = [_t(crd, True) for crd in coords]
    outs = kernels.bilinear_sample_full_multi(
        [ti.permute(0, 3, 1, 2) for ti in tis], [tc[..., 0] for tc in tcs],
        [tc[..., 1] for tc in tcs])
    assert len(outs) == len(MULTI_SCALES)
    sum(torch.sum(torch.cos(3 * o)) for o in outs).backward()
    for out, ti, tc, (ref, gi, gc) in zip(outs, tis, tcs, refs):
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   atol=1e-5)
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-4)
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-4)
    with torch.no_grad():  # the value-only variant gives the same samples
        for out, ti, tc in zip(kernels.bilinear_sample_full_multi(
                [ti.permute(0, 3, 1, 2) for ti in tis], [tc[..., 0] for tc in tcs],
                [tc[..., 1] for tc in tcs]), tis, tcs):
            np.testing.assert_allclose(out.numpy(), kernels.bilinear_sample_full_planes(
                ti.permute(0, 3, 1, 2), tc[..., 0], tc[..., 1]).numpy(), atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_sampler_matches_pallas(case):
    """bilinear_sample_grouped_planes (P6 port) vs
    bilinear_sample_pallas_grouped: plane i samples source i // group;
    value ≤1e-5 and coords gradient ≤1e-4 abs."""
    scale, huge = CASES[case]
    group = 3
    rng = np.random.default_rng(6)
    img = rng.random((2, 8, 128, 3), dtype=np.float32)
    coords = _coords(2 * group, 8, 128, 7, scale, huge)
    loss = lambda c: jnp.sum(jnp.cos(3 * bilinear_sample_pallas_grouped(img, c, group)))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        ref = bilinear_sample_pallas_grouped(jnp.asarray(img), jnp.asarray(coords), group)
        gc = jax.grad(loss)(coords)
    tc = _t(coords, True)
    src = _t(img).permute(0, 3, 1, 2)
    out = kernels.bilinear_sample_grouped_planes(src, tc[..., 0], tc[..., 1], group)
    out = out.permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    torch.sum(torch.cos(3 * out)).backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(
            kernels.bilinear_sample_grouped_planes(src, _t(coords[..., 0]), _t(coords[..., 1]),
                                                   group).permute(0, 2, 3, 1).numpy(),
            np.asarray(ref), atol=1e-5)


def _fused_port(src, tgt, coords, lcc_mode, window):
    """The port's warp_photometric on NHWC numpy inputs: (e, coords grad of
    Σcos(4e)) through the CPU path (plain forward, plain analytic backward)."""
    tc = _t(coords, True)
    e = warp_photometric(_t(src).permute(0, 3, 1, 2), _t(tgt).permute(0, 3, 1, 2),
                         tc[..., 0], tc[..., 1], lcc_mode, window, 0.85)
    torch.sum(torch.cos(4 * e)).backward()
    return e.detach().numpy(), tc.grad.numpy()


def _fused_inputs(h, w, c, seed):
    rng = np.random.default_rng(seed)
    src = rng.random((1, h, w, c), dtype=np.float32)
    tgt = rng.random((1, h, w, c), dtype=np.float32)
    return src, tgt, _coords(1, h, w, seed + 1, 2.0, False)


def test_fused_loss_matches_pallas_without_lcc():
    """P7/P8 ports (plain forward and analytic backward) vs
    warp_photometric_pallas with lcc_window=0 in interpret mode, at the
    JAX suite's (1, 32, 128, 2): e ≤2e-5 and coords gradient ≤5e-5 abs."""
    src, tgt, coords = _fused_inputs(32, 128, 2, 8)
    with pltpu.force_tpu_interpret_mode():  # one interpreted forward and backward
        ref, vjp = jax.vjp(lambda c: warp_photometric_pallas(src, tgt, c, 0, 0.85),
                           jnp.asarray(coords))
        (gc,) = vjp(-4 * jnp.sin(4 * ref))  # the gradient of Σcos(4e)
    e, g = _fused_port(src, tgt, coords, "off", 0)
    np.testing.assert_allclose(e, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(g, np.asarray(gc), atol=5e-5)


@pytest.mark.parametrize("h,w,c", [(32, 128, 2), (23, 37, 3)])
def test_fused_loss_with_lcc_matches_composed_reference(h, w, c):
    """P7/P8 ports at lcc_window=15 vs the JAX composed XLA pipeline
    (sampler → affine LCC → SSIM+L1, tests/test_kernels.py's xla_ref):
    e ≤2e-5 and coords gradient ≤5e-5 abs, also at a size no tile divides."""
    src, tgt, coords = _fused_inputs(h, w, c, 3)

    def xla_ref(crd):
        warped = jax_lcc_calibrate(jax_bilinear_sample(src, crd), tgt, "affine", 15)
        return jax_photometric_error(warped, tgt, 0.85)

    ref = xla_ref(jnp.asarray(coords))
    gc = jax.grad(lambda c_: jnp.sum(jnp.cos(4 * xla_ref(c_))))(jnp.asarray(coords))
    e, g = _fused_port(src, tgt, coords, "affine", 15)
    np.testing.assert_allclose(e, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(g, np.asarray(gc), atol=5e-5)


@pytest.mark.parametrize("window", [0, 15])
@pytest.mark.parametrize("c", [1, 3])
def test_fused_loss_plain_backward_is_autograd_of_plain_forward(window, c):
    """err_bwd_plain (the kernel's analytic transpose: SSIM terms, L1 sign,
    ·a with a and b held constant, the /C of the channel mean) equals
    torch.autograd of err_plain to 1e-5 relative L2, with ±1e20 coords and
    a cotangent zeroed on a band."""
    rng = np.random.default_rng(9 + c)
    src = _t(rng.random((2, c, 22, 30), dtype=np.float32))
    tgt = _t(rng.random((2, c, 19, 26), dtype=np.float32))
    coords = _coords(2, 19, 26, 10, 3.0, True)
    x, y = _t(coords[..., 0], True), _t(coords[..., 1], True)
    g = _t(rng.normal(size=(2, 19, 26)).astype(np.float32))
    g[:, :3] = 0.0
    e = fused_loss.err_plain(src, tgt, x, y, window, 0.85)
    torch.sum(e * g).backward()
    gx, gy = fused_loss.err_bwd_plain(src, tgt, x.detach(), y.detach(), g, window, 0.85)
    for got, want in ((gx, x.grad), (gy, y.grad)):
        assert (got - want).norm().item() <= 1e-5 * want.norm().item()


def test_plain_scatter_is_the_gather_transpose():
    """scatter_plain is the adjoint of sample_plain: <S(src), g> == <src, T(g)>."""
    rng = np.random.default_rng(5)
    src = _t(rng.random((3, 2, 9, 13), dtype=np.float32))
    coords = _coords(3, 7, 12, 6, 6.0, True)
    x, y = _t(coords[..., 0]), _t(coords[..., 1])
    g = _t(rng.normal(size=(3, 2, 7, 12)).astype(np.float32))
    lhs = torch.sum(sampler.sample_plain(src, x, y, False)[0] * g)
    rhs = torch.sum(src * scatter.scatter_plain(x, y, g, 9, 13))
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    coords = _t(_coords(1, 8, 8, 7, 1.0, False), True)
    img = _t(np.ones((1, 8, 8, 1), np.float32), True)
    kernels.bilinear_sample_full(img, coords).sum().backward()
    planes = img.permute(0, 3, 1, 2)
    sum(o.sum() for o in kernels.bilinear_sample_full_multi(
        [planes, planes], [coords[..., 0]] * 2, [coords[..., 1]] * 2)).backward()
    kernels.bilinear_sample_fast(img, coords).sum().backward()
    planes = img.detach().permute(0, 3, 1, 2)
    kernels.bilinear_sample_grouped_planes(planes, coords[..., 0], coords[..., 1], 1).sum().backward()
    warp_photometric(planes, planes, coords[..., 0], coords[..., 1], "affine", 15,
                     0.85).sum().backward()
    assert kernels.launch_counts() == {}


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which raises for
    anything it cannot launch on; there is no fallback."""
    src = torch.empty((1, 1, 4, 4), device="meta")
    x = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample(src, x, x, True)
    with pytest.raises(ValueError, match="CUDA"):
        scatter.scatter(x, x, src, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample_multi([src, src], [x, x], [x, x], False)
    with pytest.raises(ValueError, match="CUDA"):
        scatter.scatter_multi([x, x], [x, x], [src, src], [(4, 4), (4, 4)])
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample(src, x, x, True, 2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.err(src, src, x, x, 15, 0.85)
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.err_bwd(src, src, x, x, x, 15, 0.85)
    mats = (x, torch.empty((3, 3), device="meta"), torch.empty((3, 3), device="meta"),
            torch.empty((2, 1, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        project.project_depth(*mats)
    with pytest.raises(ValueError, match="CUDA"):
        project.forward(*mats)
    frames = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lcc.lcc_window(frames, frames, 3)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("sampler")
