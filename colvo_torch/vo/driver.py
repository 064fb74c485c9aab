"""Full-sequence VO driver (port of ``colvo/vo/driver.py``).

Runs coupled depth + pose over a frame stream and chains the relative
poses into a trajectory on the host in float64, through the native library
(``colvo_torch/native``), with a periodic renormalisation of the rotation
against drift over thousands of frames. The streaming path's chaining is
the span ``vo.chain`` (``runtime.spans``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List

import numpy as np

from colvo_torch import native
from colvo_torch.runtime.infer import InferenceRunner
from colvo_torch.runtime.spans import span


@dataclass
class VOResult:
    """Trajectory + per-frame outputs of a VO run.

    poses: (N, 4, 4) cam→world (frame 0 = identity/world origin).
    depths: list of kept (H, W) depth maps (every ``keyframe_every``-th).
    keyframe_ids: frame indices of the kept depth maps.
    """

    poses: np.ndarray
    depths: List[np.ndarray] = field(default_factory=list)
    keyframe_ids: List[int] = field(default_factory=list)

    @property
    def positions(self) -> np.ndarray:
        return self.poses[:, :3, 3]


def _axis_angle_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3)
    k = aa / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def _renorm(rot: np.ndarray) -> np.ndarray:
    """Project back onto SO(3) (host float64, by SVD)."""
    u, _, vt = np.linalg.svd(rot)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def _rel6_to_mat(rel6: np.ndarray) -> np.ndarray:
    """(6,) (axisangle, translation) → 4×4 float64 transform."""
    rel = np.eye(4, dtype=np.float64)
    rel[:3, :3] = _axis_angle_to_matrix_np(rel6[:3].astype(np.float64))
    rel[:3, 3] = rel6[3:].astype(np.float64)
    return rel


def _rel_mats(rel6: np.ndarray) -> np.ndarray:
    if not len(rel6):
        return np.zeros((0, 4, 4), np.float64)
    return np.stack([_rel6_to_mat(r) for r in rel6])


def chain_relative_poses(rel6: np.ndarray, renorm_every: int = 50) -> np.ndarray:
    """Chain (N, 6) relative prev→cur pose params into (N+1, 4, 4)
    cam→world poses (float64; periodic rotation renormalisation), through
    the native library. A failed build or load raises."""
    return native.chain_poses(_rel_mats(rel6), renorm_every=renorm_every)


def chain_relative_poses_np(rel6: np.ndarray, renorm_every: int = 50) -> np.ndarray:
    """The plain numpy version of :func:`chain_relative_poses` (SVD
    renormalisation in place of Gram–Schmidt; the two agree to rounding
    while the rotation has drifted only by rounding)."""
    rels = _rel_mats(rel6)
    poses = [np.eye(4, dtype=np.float64)]
    t_wc = np.eye(4, dtype=np.float64)
    for i in range(len(rels)):
        t_wc = t_wc @ np.linalg.inv(rels[i])
        if renorm_every > 0 and (i + 1) % renorm_every == 0:
            t_wc[:3, :3] = _renorm(t_wc[:3, :3])
        poses.append(t_wc.copy())
    return np.stack(poses)


def run_vo(
    runner,
    frames: Iterable[np.ndarray],
    keyframe_every: int = 1,
    renorm_every: int = 50,
    batch_pairs: int = 1,
    chunk_size: int = 16,
    depth_dtype: str = "float16",
    input_format: str = "rgb",
    symmetric_pose: bool = False,
) -> VOResult:
    """Run VO over a frame stream.

    Args:
        runner: an :class:`InferenceRunner`, or any object with
            ``infer_coupled`` (then the per-pair loop below runs).
        frames: iterable of (H, W, 3) frames, uint8 (normalised on the
            device) or float in [0, 1]; with ``input_format="i420"`` or
            ``"i420full"``, planar (H·3/2, W) uint8 YUV as video decoders
            emit it.
        keyframe_every: keep the depth map of every k-th frame (frame 0
            always).
        renorm_every: renormalise the chained rotation every k frames.
        batch_pairs: unused; kept in fifth place, as in the reference, so
            that positional calls bind the same parameters.
        chunk_size, depth_dtype, symmetric_pose: see :class:`StreamingVO`.

    Self-supervised monocular VO is scale-ambiguous: the trajectory is in
    the network's scale, and evaluation aligns it by a similarity.
    """
    if isinstance(runner, InferenceRunner):
        from colvo_torch.vo.stream import StreamingVO

        # The stream keeps only keyframe depths (O(N/k) host memory).
        depths_kf, rel6 = StreamingVO(
            runner, chunk_size=chunk_size, depth_dtype=depth_dtype,
            input_format=input_format, symmetric_pose=symmetric_pose,
        ).run(frames, keyframe_every=keyframe_every)
        if not depths_kf:
            return VOResult(poses=np.eye(4)[None].astype(np.float64))
        with span("vo.chain"):
            poses = chain_relative_poses(rel6, renorm_every=renorm_every)
        ids = [i for i in range(poses.shape[0]) if i % keyframe_every == 0]
        assert len(ids) == len(depths_kf), (len(ids), len(depths_kf))
        return VOResult(poses=poses, depths=depths_kf, keyframe_ids=ids)

    if input_format != "rgb":
        raise ValueError(
            "planar I420 input is only supported on the streaming path "
            "(InferenceRunner); the per-pair duck-typed path takes RGB frames"
        )
    it = iter(frames)
    try:
        prev = next(it)
    except StopIteration:
        return VOResult(poses=np.eye(4)[None].astype(np.float64))

    poses = [np.eye(4, dtype=np.float64)]
    depths: List[np.ndarray] = []
    keyframe_ids: List[int] = []
    t_wc = np.eye(4, dtype=np.float64)  # current cam→world
    idx = 0
    for cur in it:
        depth_a, _depth_b, aa, tr = runner.infer_coupled(prev[None], cur[None])
        if idx % keyframe_every == 0:
            depths.append(depth_a[0])
            keyframe_ids.append(idx)
        # the network gives T_{prev→cur} (target=prev, source=cur); the new
        # camera pose in world is T_wc_prev · T_{prev→cur}⁻¹.
        rel = np.eye(4, dtype=np.float64)
        rel[:3, :3] = _axis_angle_to_matrix_np(np.asarray(aa[0], dtype=np.float64))
        rel[:3, 3] = np.asarray(tr[0], dtype=np.float64)
        t_wc = t_wc @ np.linalg.inv(rel)
        if renorm_every > 0 and (idx + 1) % renorm_every == 0:
            t_wc[:3, :3] = _renorm(t_wc[:3, :3])
        poses.append(t_wc.copy())
        prev = cur
        idx += 1

    # keep the final frame's depth too (completes the reconstruction)
    if idx % keyframe_every == 0 or not depths:
        depth_last, _, _, _ = runner.infer_coupled(prev[None], prev[None])
        depths.append(depth_last[0])
        keyframe_ids.append(idx)

    return VOResult(poses=np.stack(poses), depths=depths, keyframe_ids=keyframe_ids)
