"""colvo_torch.geometry against colvo.geometry: SE(3) and projective ops,
values and gradients, at float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvo.geometry import ops as jops
from colvo.geometry import se3 as jse3
from colvo_torch.geometry import ops as tops
from colvo_torch.geometry import se3 as tse3

torch.set_num_threads(2)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _axis_angles(seed):
    rng = np.random.default_rng(seed)
    aa = rng.normal(0, 0.5, (6, 3)).astype(np.float32)
    aa[0] = 0.0  # θ = 0 exactly: the Taylor branch, gradients must stay finite
    aa[1] *= 1e-6  # inside the Taylor band
    return aa


@pytest.mark.parametrize(
    "name", ["axis_angle_to_matrix", "se3_exp", "transformation_from_parameters"]
)
def test_se3_forward_maps_match(name):
    """Values and gradients (of Σcos f) match, including at θ = 0."""
    aa = _axis_angles(0)
    tr = np.random.default_rng(1).normal(0, 0.1, (6, 3)).astype(np.float32)
    if name == "axis_angle_to_matrix":
        args = (aa,)
    elif name == "se3_exp":
        args = (np.concatenate([aa, tr], -1),)
    else:
        args = (aa, tr)
    jf, tf = getattr(jse3, name), getattr(tse3, name)
    ref = jf(*map(jnp.asarray, args))
    targs = [_t(a, grad=True) for a in args]
    out = tf(*targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.cos(jf(*a))), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args)
    )
    torch.sum(torch.cos(out)).backward()
    for ta, jg in zip(targs, jgrads):
        assert torch.isfinite(ta.grad).all()
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_se3_inverse_maps_match():
    """Log maps, inversion and renormalisation agree with the reference."""
    rng = np.random.default_rng(2)
    xi = np.concatenate([_axis_angles(3), rng.normal(0, 0.1, (6, 3))], -1).astype(np.float32)
    mat = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    mat_t = _t(mat)
    np.testing.assert_allclose(tse3.se3_log(mat_t).numpy(), np.asarray(jse3.se3_log(mat)), atol=1e-5)
    np.testing.assert_allclose(
        tse3.matrix_to_axis_angle(mat_t[..., :3, :3]).numpy(),
        np.asarray(jse3.matrix_to_axis_angle(mat[..., :3, :3])), atol=1e-5)
    np.testing.assert_allclose(
        tse3.invert_transform(mat_t).numpy(), np.asarray(jse3.invert_transform(mat)), atol=1e-6)
    noisy = mat + rng.normal(0, 1e-3, mat.shape).astype(np.float32)
    np.testing.assert_allclose(
        tse3.renormalize_rotation(_t(noisy)).numpy(),
        np.asarray(jse3.renormalize_rotation(jnp.asarray(noisy))), atol=1e-6)
    aa, tr = xi[:, :3], xi[:, 3:]
    np.testing.assert_allclose(
        tse3.transformation_from_parameters(_t(aa), _t(tr), invert=True).numpy(),
        np.asarray(jse3.transformation_from_parameters(aa, tr, invert=True)), atol=1e-6)


def _intrinsics(h, w):
    return np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("batched_k", [False, True])
def test_projection_chain_matches(batched_k):
    """disp→depth → backproject → project → valid mask, values and the
    gradient of the projected coords/z with respect to depth and pose."""
    rng = np.random.default_rng(4)
    b, h, w = 2, 12, 16
    disp = rng.uniform(0.05, 0.95, (b, h, w)).astype(np.float32)
    k = _intrinsics(h, w)
    if batched_k:
        k = np.stack([k, k * np.array([[1.1], [0.9], [1]], np.float32)])
    k_inv = np.linalg.inv(k).astype(np.float32)
    xi = np.concatenate([rng.normal(0, 0.05, (b, 3)), rng.normal(0, 0.02, (b, 3))], -1)
    xi = xi.astype(np.float32)

    def jchain(disp, xi):
        _, depth = jops.disp_to_depth(disp, 0.01, 1.0)
        pix, z = jops.project(jops.backproject(depth, k_inv), k,
                              jse3.transformation_from_parameters(xi[:, :3], xi[:, 3:]))
        return pix, z, jops._valid_mask(pix, h, w)

    def tchain(disp, xi):
        _, depth = tops.disp_to_depth(disp, 0.01, 1.0)
        pix, z = tops.project(tops.backproject(depth, _t(k_inv)), _t(k),
                              tse3.transformation_from_parameters(xi[:, :3], xi[:, 3:]))
        return pix, z, tops._valid_mask(pix, h, w)

    jp, jz, jm = jchain(disp, xi)
    td, tx = _t(disp, True), _t(xi, True)
    tp, tz, tm = tchain(td, tx)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    gd, gx = jax.grad(lambda d, x: jnp.sum(jnp.sin(0.1 * jchain(d, x)[0])) + jnp.sum(jchain(d, x)[1]),
                      argnums=(0, 1))(disp, xi)
    (torch.sum(torch.sin(0.1 * tp)) + torch.sum(tz)).backward()
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-3)


def test_pixel_grid_and_disp_inverse():
    np.testing.assert_array_equal(tops.pixel_grid(5, 7).numpy(), np.asarray(jops.pixel_grid(5, 7)))
    depth = np.linspace(0.01, 1.0, 11, dtype=np.float32)
    np.testing.assert_allclose(tops.depth_to_disp(_t(depth), 0.01, 1.0).numpy(),
                               np.asarray(jops.depth_to_disp(depth, 0.01, 1.0)), atol=1e-6)


def _warp_coords(b, h, w, seed, scale, huge):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x = gx[None] + rng.normal(0, scale, (b, h, w)).astype(np.float32) + 0.3
    y = gy[None] + rng.normal(0, scale, (b, h, w)).astype(np.float32) + 0.3
    if huge:  # far right/left/below/above, and past int32 range
        x[0, 1, 3], x[0, 2, 5], x[1, 5, 11] = 1e20, -1e20, 3e9
        y[0, 3, 7], y[0, 4, 9] = 1e20, -1e20
    return np.stack([x, y], -1)


@pytest.mark.parametrize("scale,huge", [(1.5, False), (20.0, False), (1.5, True)])
def test_bilinear_sample_matches_xla_gather(scale, huge):
    """Border-clamped gather: value and gradients to image and coords,
    including far out-of-bounds coords and floor(x) ≥ 2³¹."""
    rng = np.random.default_rng(5)
    img = rng.random((2, 10, 14, 2), dtype=np.float32)
    coords = _warp_coords(2, 10, 14, 6, scale, huge)
    ref = jops.bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    ti, tc = _t(img, True), _t(coords, True)
    out = tops.bilinear_sample(ti, tc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    gi, gc = jax.grad(lambda i, c: jnp.sum(jnp.cos(3 * jops.bilinear_sample(i, c))),
                      argnums=(0, 1))(img, coords)
    torch.sum(torch.cos(3 * out)).backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-5)


def test_warp_helpers_match():
    rng = np.random.default_rng(7)
    b, h, w = 2, 12, 16
    k = _intrinsics(h, w)
    k_inv = np.linalg.inv(k).astype(np.float32)
    depth = rng.uniform(0.05, 1.0, (b, h, w)).astype(np.float32)
    src_depth = rng.uniform(0.05, 1.0, (b, h, w)).astype(np.float32)
    img = rng.random((b, h, w, 3), dtype=np.float32)
    t_mat = np.asarray(jse3.se3_exp(rng.normal(0, 0.05, (b, 6)).astype(np.float32)))
    jw, jm = jops.inverse_warp(img, depth, t_mat, k, k_inv)
    tw, tm = tops.inverse_warp(_t(img), _t(depth), _t(t_mat), _t(k), _t(k_inv))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jr = jops.reproject_depth(src_depth, depth, t_mat, k, k_inv)
    tr = tops.reproject_depth(_t(src_depth), _t(depth), _t(t_mat), _t(k), _t(k_inv))
    for a, r in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
