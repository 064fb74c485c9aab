"""T's deterministic function in PyTorch (``scatter_plain_fixed``), on the
CPU: each tap's term rounded on its own in its plane's fixed point and
summed in int64, against the float plain version, the JAX package's
``bilinear_sample_fullgrad`` and itself under a permutation of the terms.
The kernel is held to it bit for bit in ``test_torch_port_geo_emu.py``
(emulated) and in ``chip_smoke.py`` and ``test_torch_port_cuda.py`` (on
the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from colvo.kernels.scatter import bilinear_sample_fullgrad
from colvo_torch import kernels
from colvo_torch.kernels import scatter

torch.set_num_threads(2)


def _inputs(n, c, h, w, hs, ws, seed, kind):
    """Coordinates onto an (hs, ws) source: ``smooth`` (a zoom with noise
    and a band out of bounds), ``wild`` (uniform over and beyond it) or
    ``huge`` (smooth with ±1e20 and 3e9); g normal with zero rows."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if kind == "wild":
        x = rng.uniform(-3, ws + 3, (n, h, w))
        y = rng.uniform(-3, hs + 3, (n, h, w))
    else:
        x = gx[None] * (ws / w) + rng.normal(0, 0.7, (n, h, w))
        y = gy[None] * (hs / h) + rng.normal(0, 0.7, (n, h, w))
        x[:, :, :2] = rng.uniform(-20, ws + 20, (n, h, 2))
        if kind == "huge":
            x[0, 1, 3], x[0, 2, 5], x[-1, -1, -2] = 1e20, -1e20, 3e9
            y[0, 3, 1], y[-1, 2, 4] = 1e20, -1e20
    g = rng.normal(size=(n, c, h, w)) * 10.0 ** rng.uniform(-3, 3, (n, c, 1, 1))
    g[:, :, : h // 4] = 0.0
    f = lambda a: torch.tensor(a.astype(np.float32))  # noqa: E731
    return f(x), f(y), f(g)


SHAPES = [(3, 1, 16, 24, 18, 26, "smooth"), (2, 2, 11, 17, 13, 15, "huge"),
          (2, 1, 40, 80, 30, 40, "wild"), (1, 1, 64, 80, 64, 80, "smooth")]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[-1] + str(s[2]) for s in SHAPES])
def test_plain_fixed_is_near_the_float_plain_version(shape):
    """Within 1e-6 of max|d_src| of ``scatter_plain`` (the quantum is about
    max|g|·2^-40 a term; float32 sums round at ~6e-8), plane by plane,
    planes of g spanning six decades."""
    x, y, g = _inputs(*shape[:6], 1, shape[6])
    hs, ws = shape[4:6]
    got = scatter.scatter_plain_fixed(x, y, g, hs, ws)
    want = scatter.scatter_plain(x, y, g, hs, ws)
    assert got.dtype == torch.float32 and got.shape == want.shape
    for p, q in zip(got.reshape(-1, hs * ws), want.reshape(-1, hs * ws)):
        assert (p - q).abs().max() <= 1e-6 * q.abs().max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_fixed_bits_do_not_depend_on_the_order_of_the_terms(seed):
    """The int64 sums of the terms permuted at random before the
    ``index_add_`` give the same bits: the function has no order."""
    n, c, h, w, hs, ws, kind = SHAPES[seed]
    x, y, g = _inputs(n, c, h, w, hs, ws, 2 + seed, kind)
    idx, q, bad, mb, s = scatter.fixed_point_terms(x, y, g, hs, ws)
    perm = torch.randperm(idx.numel(), generator=torch.Generator().manual_seed(seed))
    sums = torch.zeros(n * c * hs * ws, dtype=torch.int64).index_add_(0, idx[perm], q[perm])
    permuted = scatter.from_fixed_point(sums, bad, mb, s, (n, c, hs, ws))
    want = scatter.scatter_plain_fixed(x, y, g, hs, ws)
    assert torch.equal(permuted.view(torch.int32), want.view(torch.int32))


def test_plain_fixed_nan_and_zero_planes():
    """A NaN or inf in g, or a NaN coordinate under g ≠ 0, makes the
    plane NaN in every cell; g = 0 everywhere makes it 0; a NaN
    coordinate under g = 0 adds nothing; the other planes are finite."""
    x, y, g = _inputs(5, 1, 16, 24, 18, 26, 4, "smooth")
    g[0, 0, 8, 3] = float("nan")
    g[1, 0, 9, 4] = float("-inf")
    g[2] = 0.0
    x[3, 10, 10] = float("nan")
    x[4, 0, 0] = float("nan")  # row 0 has g = 0
    got = scatter.scatter_plain_fixed(x, y, g, 18, 26)
    assert torch.isnan(got[:2]).all() and torch.isnan(got[3]).all()
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert torch.isfinite(got[4]).all()
    want = scatter.scatter_plain(x[4:], y[4:], g[4:], 18, 26)
    assert (got[4:] - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("kind", ["smooth", "huge"])
def test_plain_fixed_matches_the_reference_source_gradient(kind):
    """``scatter_plain_fixed`` of the cotangent against the source gradient
    of ``colvo``'s ``bilinear_sample_fullgrad`` (its Pallas scatter in
    interpret mode) for the same g: ≤1e-4 abs, the tolerance of the float
    port (another order of sums)."""
    x, y, g = _inputs(2, 1, 16, 40, 16, 40, 6, kind)
    img = np.random.default_rng(7).random((2, 16, 40, 1), dtype=np.float32)
    coords = jnp.stack([jnp.asarray(x.numpy()), jnp.asarray(y.numpy())], -1)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda i: bilinear_sample_fullgrad(i, coords), jnp.asarray(img))
        (ref,) = vjp(jnp.asarray(g.permute(0, 2, 3, 1).numpy()))
    got = scatter.scatter_plain_fixed(x, y, g, 16, 40)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4)


def test_cpu_path_stays_the_float_plain_version_under_deterministic_mode():
    """On the CPU ``scatter_multi`` takes ``scatter_plain`` in both modes
    (deterministic there, and what the CPU parity tests hold against
    ``colvo``), and launches nothing."""
    x, y, g = _inputs(2, 1, 16, 24, 18, 26, 8, "smooth")
    kernels.reset_launch_counts()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = scatter.scatter_multi([x], [y], [g], [(18, 26)])[0]
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got, scatter.scatter_plain(x, y, g, 18, 26))
    assert kernels.launch_counts() == {}
