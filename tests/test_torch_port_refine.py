"""colvo_torch.vo.refine against colvo.vo.refine at 64×96 float32 on the
CPU: ``_segment_loss`` and its gradient with respect to the se(3) delta, a
short refinement with a padded batch (poses, residuals and each pair's
keep decision), and the reference's perturbed-pose contract
(tests/test_refine.py) at 64×96. The reference runs on the CPU through its
XLA sampler, as its own tests do; the port through the sampler's plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colvo.vo.refine as jax_refine
from colvo.data.synthetic import default_intrinsics, make_trajectory, render_frame
from colvo_torch.vo import refine

torch.set_num_threads(2)

H, W = 64, 96
TOL_LOSS_REL = 1e-5  # the mean residual, relative
TOL_GRAD = 1e-4  # the delta's gradient, of its max
TOL_POSE = 1e-4  # refined poses


@pytest.fixture(scope="module")
def scene():
    """Rendered frames and depths at 7 poses of a trajectory (seeded)."""
    k = default_intrinsics(H, W)
    gt = make_trajectory(8, step=0.004, wobble=0.3, seed=31).astype(np.float64)
    frames, depths = [], []
    for i in range(7):
        f, d = render_frame(gt[i], k, H, W, radius=0.03)
        frames.append(f.astype(np.float32))
        depths.append(d.astype(np.float32))
    return k, gt, np.stack(frames), np.stack(depths)


def _rel(poses, ids):
    return np.stack([np.linalg.inv(poses[ids[i + 1]]) @ poses[ids[i]]
                     for i in range(len(ids) - 1)]).astype(np.float32)


def test_segment_loss_and_its_delta_gradient_match_the_reference(scene):
    k, gt, frames, depths = scene
    ids = [0, 2, 4]
    rel = _rel(gt, ids)
    delta = np.random.default_rng(0).normal(0, 2e-3, (2, 6)).astype(np.float32)
    k32 = k.astype(np.float32)
    k_inv = np.linalg.inv(k32).astype(np.float32)
    args = (rel, frames[ids[:-1]], frames[ids[1:]], depths[ids[:-1]], depths[ids[1:]], k32,
            k_inv)

    def jax_loss(d):
        return jax_refine._segment_loss(d, *map(jnp.asarray, args), 0.5)

    (want, want_pair), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(delta))
    d_t = torch.tensor(delta, requires_grad=True)
    got, got_pair = refine._segment_loss(d_t, *map(torch.from_numpy, args), 0.5)
    got.backward()
    assert abs(got.item() - float(want)) <= TOL_LOSS_REL * abs(float(want))
    np.testing.assert_allclose(got_pair.detach().numpy(), np.asarray(want_pair), rtol=TOL_LOSS_REL)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(d_t.grad.numpy(), want_g, rtol=0,
                               atol=TOL_GRAD * np.abs(want_g).max())


def test_short_refine_with_a_padded_batch_matches_the_reference(scene):
    """Three keyframe pairs in batches of 2 (the second call repeats its
    last pair), 4 Adam steps, on a trajectory with perturbed segments: the
    refined poses to 1e-4, the residuals, and each pair's keep decision
    (whether its refined transform moved) agree."""
    k, gt, frames, depths = scene
    ids = [0, 2, 4, 6]
    poses = gt[:7].copy()
    rng = np.random.default_rng(1)
    for i in (2, 4, 6):  # bump each keyframe and what follows it
        bump = np.eye(4)
        bump[:3, 3] = rng.normal(0, 1e-3, 3)
        poses[i:] = np.einsum("ij,njk->nik", bump, poses[i:])
    kw = dict(keyframe_ids=ids, depths=list(depths[ids]), frames_kf=frames[ids], k=k, iters=4,
              lr=2e-3, batch=2)
    want, want_stats = jax_refine.refine_keyframe_poses(poses, **kw)
    got, got_stats = refine.refine_keyframe_poses(poses, device="cpu", **kw)
    assert got.dtype == np.float64 and got.shape == poses.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_POSE)
    assert got_stats["pairs"] == want_stats["pairs"] == 3
    for key in ("residual_before", "residual_after"):
        assert abs(got_stats[key] - want_stats[key]) <= 1e-5 * abs(want_stats[key]), key

    rel = _rel(poses, ids)
    k32 = k.astype(np.float32)
    a = (rel, frames[ids[:-1]], frames[ids[1:]], depths[ids[:-1]], depths[ids[1:]], k32)
    t_want = np.asarray(jax_refine._refine_jit(*map(jnp.asarray, a), iters=4, lr=2e-3)[0])
    t_got = refine._refine(*map(torch.from_numpy, a), iters=4, lr=2e-3)[0].numpy()
    keep_want = ~np.all(np.isclose(t_want, rel, rtol=0, atol=1e-7), axis=(1, 2))
    keep_got = ~np.all(np.isclose(t_got, rel, rtol=0, atol=1e-7), axis=(1, 2))
    np.testing.assert_array_equal(keep_got, keep_want)
    assert keep_got.any()


def _rot_err_deg(a, b):
    r = a[:3, :3].T @ b[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))


def test_refine_recovers_perturbed_pose():
    """tests/test_refine.py's contract at 64×96: a 1.2° + 2.7 mm error
    injected at keyframe 4 shrinks below 0.5× (rotation) and 0.7×
    (translation); keyframe 0 and the intra-segment chains stay put."""
    k = default_intrinsics(H, W)
    gt = make_trajectory(8, step=0.004, wobble=0.3, seed=31).astype(np.float64)
    frames, depths = [], []
    for i in (0, 4):
        f, d = render_frame(gt[i], k, H, W, radius=0.03)
        frames.append(f.astype(np.float32))
        depths.append(d.astype(np.float32))
    poses = gt.copy()[:8]
    bump = np.eye(4)
    th = np.radians(1.2)
    bump[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                             [0, 0, 1]])
    bump[:3, 3] = [0.002, -0.001, 0.0015]
    poses[4:] = np.einsum("ij,njk->nik", bump, poses[4:])
    err0 = _rot_err_deg(poses[4], gt[4])
    t_err0 = np.linalg.norm(poses[4][:3, 3] - gt[4][:3, 3])
    assert err0 > 1.0

    refined, stats = refine.refine_keyframe_poses(
        poses, keyframe_ids=[0, 4], depths=depths, frames_kf=np.stack(frames), k=k, iters=40,
        lr=2e-3, batch=1, device="cpu")
    err1 = _rot_err_deg(refined[4], gt[4])
    t_err1 = np.linalg.norm(refined[4][:3, 3] - gt[4][:3, 3])
    assert stats["pairs"] == 1
    assert stats["residual_after"] <= stats["residual_before"] + 1e-9
    assert err1 < 0.5 * err0, (err0, err1)
    assert t_err1 < 0.7 * t_err0, (t_err0, t_err1)
    np.testing.assert_allclose(refined[0], poses[0], atol=1e-12)
    for a, b in ((0, 2), (4, 6)):
        np.testing.assert_allclose(np.linalg.inv(refined[a]) @ refined[b],
                                   np.linalg.inv(poses[a]) @ poses[b], atol=1e-9)
