"""colvo_torch's trajectory alignment, reconstruction, polyp localisation
and depth/pose evaluation against colvo's on the same numpy inputs, and
the evaluation path as a whole (``colvo.pipelines.evaluate_synthetic``
without its figures) on a rendered sequence, at float32 on the CPU."""

import math

import flax
import numpy as np
import pytest
import torch

import colvo.evaluation.depth as jax_depth_eval
import colvo.evaluation.pose as jax_pose_eval
import colvo.vo as jax_vo
from colvo.config import ColvoConfig as JaxConfig
from colvo.data import render_sequence as jax_render_sequence
from colvo.runtime.infer import InferenceRunner as JaxRunner
import colvo_torch.evaluation as port_eval
import colvo_torch.vo as port_vo
from colvo_torch.config import ColvoConfig
from colvo_torch.data import make_trajectory, render_sequence
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner, flax_params, params_from_flax
from colvo_torch.vo.recon import voxel_downsample_np

torch.set_num_threads(2)

H, W = 64, 96
TOL = 1e-10


def _configs():
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    jcfg.data.height = tcfg.data.height = H
    jcfg.data.width = tcfg.data.width = W
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runners():
    """(reference runner, port runner) over the same random weights, with
    every parameter away from its init value."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in ColVOModel(tcfg.model).state_dict().items():
        if v.ndim == 4:
            a = rng.normal(0, 1 / math.sqrt(v[0].numel()), v.shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.05 * rng.normal(size=v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    flat = flax_params(sd)
    ref = JaxRunner(jcfg, flax.traverse_util.unflatten_dict(flat, sep="/"))
    return ref, InferenceRunner(tcfg, params_from_flax(flat), device="cpu")


def _trajectory(n, seed):
    """A ground-truth camera path and a noisy, rescaled, rotated estimate."""
    rng = np.random.default_rng(seed)
    gt = make_trajectory(n, step=0.004, wobble=0.3, seed=seed).astype(np.float64)
    pred = gt.copy()
    pred[:, :3, 3] = 0.7 * gt[:, :3, 3] @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T
    pred[:, :3, 3] += 0.001 * rng.standard_normal((n, 3))
    return pred, gt


def _vo_result(mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    pred, _ = _trajectory(n, seed)
    depths = [(0.02 + 0.05 * rng.random((H, W))).astype(np.float32) for _ in range(n)]
    depths[1][3, 4] = np.inf  # a point that the stitch drops
    return mod.VOResult(poses=pred, depths=depths, keyframe_ids=list(range(n)))


def _k():
    return np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("with_scale", [True, False])
def test_alignment_matches_reference(with_scale):
    pred, gt = _trajectory(30, 1)
    for got, want in zip(port_vo.umeyama(pred[:, :3, 3], gt[:, :3, 3], with_scale),
                         jax_vo.umeyama(pred[:, :3, 3], gt[:, :3, 3], with_scale)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(port_vo.align_trajectory(pred[:, :3, 3], gt[:, :3, 3], with_scale),
                               jax_vo.align_trajectory(pred[:, :3, 3], gt[:, :3, 3], with_scale),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(port_vo.align_poses(pred, gt[:, :3, 3], with_scale),
                               jax_vo.align_poses(pred, gt[:, :3, 3], with_scale),
                               rtol=0, atol=TOL)


def _sorted(points, colors):
    a = np.concatenate([points, colors], 1) if colors is not None else points
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("colored", [True, False])
def test_stitch_matches_reference_and_numpy_voxels(colored):
    """The stitched cloud equals colvo's; the native voxel grid equals the
    plain numpy unique-reduce as a set of points (their orders differ)."""
    frames = list(np.random.default_rng(2).random((5, H, W, 3), dtype=np.float32))
    frames = frames if colored else None
    kw = dict(frames=frames, voxel=0.002, max_depth=0.06, stride=2)
    got = port_vo.stitch_pointclouds(_vo_result(port_vo), _k(), **kw)
    want = jax_vo.stitch_pointclouds(_vo_result(jax_vo), _k(), **kw)
    assert len(got) == len(want) > 100
    np.testing.assert_allclose(got.points, want.points, rtol=0, atol=TOL)
    if colored:
        np.testing.assert_allclose(got.colors, want.colors, rtol=0, atol=TOL)
    else:
        assert got.colors is None and want.colors is None
    rng = np.random.default_rng(3)
    pts = (0.05 * rng.standard_normal((20000, 3))).astype(np.float32)
    cols = rng.random((20000, 3), dtype=np.float32) if colored else None
    native = port_vo.voxel_downsample(pts, 0.004, cols)
    plain = voxel_downsample_np(pts, 0.004, cols)
    assert 100 < len(native[0]) < len(pts)
    np.testing.assert_allclose(_sorted(*native), _sorted(*plain), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        port_vo.stitch_pointclouds(_vo_result(port_vo), _k(), max_depth_rel=1.2).points,
        jax_vo.stitch_pointclouds(_vo_result(jax_vo), _k(), max_depth_rel=1.2).points,
        rtol=0, atol=TOL)


@pytest.mark.parametrize("colored", [True, False])
def test_ply_round_trip_across_packages(tmp_path, colored):
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.random((50, 3), dtype=np.float32) if colored else None
    port_vo.save_ply(port_vo.PointCloud(pts, cols), str(tmp_path / "a.ply"))
    jax_vo.save_ply(jax_vo.PointCloud(pts, cols), str(tmp_path / "b.ply"))
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()
    got, want = port_vo.load_ply(str(tmp_path / "b.ply")), jax_vo.load_ply(str(tmp_path / "a.ply"))
    assert len(got) == len(want) == 50
    np.testing.assert_allclose(got.points, want.points, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.points, pts, rtol=0, atol=1e-6)
    if colored:
        np.testing.assert_allclose(got.colors, want.colors, rtol=0, atol=TOL)
    else:
        assert got.colors is None


def test_localize_polyps_matches_reference():
    dets = [(1, (10, 12, 30, 28)), (3, (-5, 40, 20, 70)), (4, (80.4, 50.6, 100, 70))]
    gt = np.random.default_rng(5).standard_normal((3, 3))
    got = port_vo.localize_polyps(_vo_result(port_vo), _k(),
                                  [port_vo.PolypDetection(f, b) for f, b in dets], gt)
    want = jax_vo.localize_polyps(_vo_result(jax_vo), _k(),
                                  [jax_vo.PolypDetection(f, b) for f, b in dets], gt)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.position_world, b.position_world, rtol=0, atol=TOL)
        assert abs(a.error - b.error) <= TOL
    with pytest.raises(KeyError):
        port_vo.localize_polyps(_vo_result(port_vo, n=3), _k(), [port_vo.PolypDetection(7, (0, 0, 4, 4))])


@pytest.mark.parametrize("median_scaling", [True, False])
def test_depth_metrics_match_reference(median_scaling):
    rng = np.random.default_rng(6)
    gt = 0.02 + 0.9 * rng.random((3, H, W))
    gt[0, :4] = 0.0  # invalid pixels
    gt[1, 5, 5] = np.nan
    pred = gt * (1.3 + 0.2 * rng.standard_normal(gt.shape))
    got = port_eval.compute_depth_errors(gt, pred, median_scaling=median_scaling)
    want = jax_depth_eval.compute_depth_errors(gt, pred, median_scaling=median_scaling)
    assert list(got) == list(port_eval.DEPTH_METRIC_NAMES)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k
    np.testing.assert_allclose(port_eval.signed_error_map(gt[0], pred[0], median_scaling),
                               jax_depth_eval.signed_error_map(gt[0], pred[0], median_scaling),
                               rtol=0, atol=TOL)


def test_evaluate_depth_matches_reference(runners):
    """The port runner through both packages' evaluate_depth (batches of 2
    over 5 frames: the tail batch padded)."""
    _, port = runners
    _, tcfg = _configs()
    rng = np.random.default_rng(7)
    frames = rng.random((5, H, W, 3), dtype=np.float32)
    gt = 0.02 + 0.5 * rng.random((5, H, W)).astype(np.float32)
    got, pred = port_eval.evaluate_depth(port, frames, gt, tcfg, batch_size=2)
    want, jpred = jax_depth_eval.evaluate_depth(port, frames, gt, tcfg, batch_size=2)
    np.testing.assert_array_equal(pred, jpred)
    assert pred.shape == (5, H, W)
    # batch 2 (the padded tail) against batch 1: conv rounding only
    np.testing.assert_allclose(pred[4], port.infer_depth(frames[4:])[0][0], rtol=1e-5)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k


@pytest.mark.parametrize("n", [4, 12])
def test_pose_metrics_match_reference(n):
    """ATE, RPE(1) and, past 6 frames, RPE(5)."""
    pred, gt = _trajectory(n, n)
    got = port_eval.evaluate_pose(pred, gt)
    want = jax_pose_eval.evaluate_pose(pred, gt)
    assert got.keys() == want.keys() and ("rpe_trans_5" in got) == (n > 6)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k
    assert abs(port_eval.ate(pred[:, :3, 3], gt[:, :3, 3], False)
               - jax_pose_eval.ate(pred[:, :3, 3], gt[:, :3, 3], False)) <= TOL
    for k, v in port_eval.rpe(pred, gt, delta=2).items():
        assert abs(v - jax_pose_eval.rpe(pred, gt, delta=2)[k]) <= TOL


def _evaluate(vo, evaluation, runner, seq, tmp_path):
    """``evaluate_synthetic``'s VO, pose, polyp and reconstruction steps,
    without figures, through one package's modules."""
    n, h, w = seq.n_frames, H, W
    res = vo.run_vo(runner, list(seq.frames), keyframe_every=1, depth_dtype="float32")
    metrics = evaluation.evaluate_pose(res.poses, seq.poses.astype(np.float64))
    rng = np.random.default_rng(5)
    k_inv = np.linalg.inv(seq.k.astype(np.float64))
    dets, gts = [], []
    for fid in (n // 4, n // 2, 3 * n // 4):
        cx, cy = int(rng.integers(w // 4, 3 * w // 4)), int(rng.integers(h // 4, 3 * h // 4))
        dets.append(vo.PolypDetection(frame_id=fid, box=(cx - 6, cy - 6, cx + 6, cy + 6)))
        pose = seq.poses[fid].astype(np.float64)
        gts.append(pose[:3, :3] @ (k_inv @ np.array([cx, cy, 1.0]) * seq.depths[fid][cy, cx])
                   + pose[:3, 3])
    aligned = vo.align_poses(res.poses, seq.poses[:, :3, 3])
    _, _, s = vo.umeyama(res.poses[:, :3, 3], seq.poses[:, :3, 3])
    res_aligned = vo.VOResult(poses=aligned, depths=[d * s for d in res.depths],
                              keyframe_ids=res.keyframe_ids)
    errors = [p.error for p in vo.localize_polyps(res_aligned, seq.k, dets, np.stack(gts))]
    metrics["polyp/e_mean"] = float(np.mean(errors))
    cloud = vo.stitch_pointclouds(res, seq.k, frames=list(seq.frames), voxel=0.002, max_depth=1.0)
    vo.save_ply(cloud, str(tmp_path / "cloud.ply"))
    metrics["cloud_points"] = len(vo.load_ply(str(tmp_path / "cloud.ply")))
    assert metrics["cloud_points"] == len(cloud) > 0
    return metrics


def test_whole_path_matches_reference(runners, tmp_path):
    """Frames in, ATE and polyp error out: port and reference agree to 1e-4
    relative on a 12-frame rendered sequence."""
    ref, port = runners
    seq = render_sequence(n_frames=12, height=H, width=W, seed=999)
    jseq = jax_render_sequence(n_frames=12, height=H, width=W, seed=999)
    np.testing.assert_array_equal(seq.frames, jseq.frames)
    np.testing.assert_array_equal(seq.poses, jseq.poses)
    got = _evaluate(port_vo, port_eval, port, seq, tmp_path)
    want = _evaluate(jax_vo, jax_pose_eval, ref, jseq, tmp_path)
    for k in ("ate", "polyp/e_mean", "rpe_trans", "rpe_rot_deg"):
        assert np.isfinite(got[k]) and got[k] > 0
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    assert abs(got["cloud_points"] - want["cloud_points"]) <= 0.01 * want["cloud_points"]
