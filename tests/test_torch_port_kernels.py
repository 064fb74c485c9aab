"""colvo_torch.kernels against the Pallas kernels of colvo.kernels (run in
interpret mode on the CPU, as tests/test_kernels.py does): the plain
versions behind the CPU path of both samplers, value, coordinate gradient
and source gradient, with out-of-bounds and ±1e20 coords. The CUDA
kernels themselves run only on a card (test_torch_port_cuda.py, and
chip_smoke.py at the training shapes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from colvo.kernels.sampler import bilinear_sample_pallas
from colvo.kernels.scatter import bilinear_sample_fullgrad
from colvo_torch import kernels
from colvo_torch.kernels import build, sampler, scatter

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
    kernels.bilinear_sample_fast(img, coords).sum().backward()
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


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("sampler")
