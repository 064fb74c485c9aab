"""colvo_torch's streaming VO (StreamingVO, run_vo, the native pose chain)
against colvo's, with the same weights carried across by
params_from_flax, at float32 on the CPU."""

import math
import sys
import threading

import flax
import numpy as np
import pytest
import torch

from colvo.config import ColvoConfig as JaxConfig
from colvo.runtime.infer import InferenceRunner as JaxRunner
from colvo.vo import run_vo as jax_run_vo
from colvo.vo.driver import chain_relative_poses as jax_chain
from colvo.vo.stream import StreamingVO as JaxStreamingVO
from colvo.vo.stream import rgb_to_i420 as jax_rgb_to_i420
from colvo_torch import native
from colvo_torch.config import ColvoConfig
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner, flax_params, params_from_flax
from colvo_torch.vo import StreamingVO, chain_relative_poses, run_vo, voxel_downsample
from colvo_torch.vo.driver import chain_relative_poses_np
from colvo_torch.vo.stream import rgb_to_i420

torch.set_num_threads(2)

H, W = 64, 96
N_FRAMES, CHUNK = 7, 3  # 7 frames: the last chunk of 3 is padded


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


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(3).random((N_FRAMES, H, W, 3), dtype=np.float32)


def _u8(frames):
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _inputs(frames, kind):
    """Frames in one of the stream's input kinds, and its input_format."""
    return {
        "f32": (frames, "rgb"),
        "u8": (_u8(frames), "rgb"),
        "i420": (rgb_to_i420(_u8(frames)), "i420"),
        "i420full": (rgb_to_i420(_u8(frames), video_range=False), "i420full"),
    }[kind]


def _both(runners, inputs, **kw):
    ref, port = runners
    got = StreamingVO(port, **kw).run(list(inputs))
    want = JaxStreamingVO(ref, **kw).run(list(inputs))
    return got, want


@pytest.mark.parametrize("kind", ["f32", "u8", "i420", "i420full"])
def test_stream_f32_wire_matches_reference(runners, frames, kind):
    """Under the float32 wire: depths to rtol 1e-4 / atol 1e-5, rel6 to
    1e-5, for each input format (the last chunk padded)."""
    inputs, fmt = _inputs(frames, kind)
    (d, p), (jd, jp) = _both(runners, inputs, chunk_size=CHUNK, depth_dtype="float32",
                             input_format=fmt)
    assert len(d) == len(jd) == N_FRAMES and p.shape == (N_FRAMES - 1, 6)
    assert p.dtype == np.float32 and all(x.dtype == np.float32 for x in d)
    np.testing.assert_allclose(np.stack(d), np.stack(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)


def test_stream_f16_wire_within_one_ulp_of_reference(runners, frames):
    """float16 wire: each depth within one float16 ulp of the reference's
    float16 depth (the two float32 depths may straddle a rounding edge);
    poses exact float32, equal to the float32 wire's."""
    inputs, _ = _inputs(frames, "u8")
    (d, p), (jd, jp) = _both(runners, inputs, chunk_size=CHUNK, depth_dtype="float16")
    d, jd = np.stack(d), np.stack(jd)
    ulp = np.spacing(jd.astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(d - jd) <= ulp)
    _, p32 = StreamingVO(runners[1], chunk_size=CHUNK, depth_dtype="float32").run(list(inputs))
    np.testing.assert_array_equal(p, p32)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)


def test_stream_u8_wire_within_one_step_of_reference(runners, frames):
    """uint8 wire: disparity within one quantisation step of the
    reference's, and within half a step of the port's float32 wire (each
    plus the float32 rounding of decoding ``lo + q·step``: a few ulps of
    the disparity); poses equal to the float32 wire's."""
    inputs, _ = _inputs(frames, "u8")
    (d, p), (jd, jp) = _both(runners, inputs, chunk_size=CHUNK, depth_dtype="uint8")
    d32, p32 = StreamingVO(runners[1], chunk_size=CHUNK, depth_dtype="float32").run(list(inputs))
    for got, want, exact in zip(d, jd, d32):
        disp, jdisp, disp32 = 1.0 / got, 1.0 / want, 1.0 / exact
        step = (disp32.max() - disp32.min()) / 255.0
        rounding = 4 * np.spacing(disp32.max())
        assert np.abs(disp - jdisp).max() <= step + rounding
        assert np.abs(disp - disp32).max() <= 0.5 * step + rounding
    np.testing.assert_array_equal(p, p32)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)


def test_symmetric_pose_matches_reference(runners, frames):
    """Rotation-only symmetric pose: rel6 equal to the reference's, the
    rotation the average of the forward and reversed readings, the
    translation the forward reading's."""
    inputs, _ = _inputs(frames, "f32")
    (_, p), (_, jp) = _both(runners, inputs, chunk_size=CHUNK, depth_dtype="float32",
                            symmetric_pose=True)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)
    port = runners[1]
    fwd = port.infer_pose(frames[:-1], frames[1:])
    rev = port.infer_pose(frames[1:], frames[:-1])
    np.testing.assert_allclose(p[:, :3], 0.5 * (fwd[:, :3] - rev[:, :3]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p[:, 3:], fwd[:, 3:], rtol=0, atol=1e-5)


def test_run_vo_keyframes_match_reference(runners, frames):
    """run_vo with keyframe_every=3: keyframes 0, 3, 6 with their depths,
    and the chained trajectory to 1e-5; keep_depths=False returns no depth
    and the same poses."""
    ref, port = runners
    got = run_vo(port, frames, keyframe_every=3, chunk_size=CHUNK, depth_dtype="float32")
    want = jax_run_vo(ref, frames, keyframe_every=3, chunk_size=CHUNK, depth_dtype="float32")
    assert got.keyframe_ids == want.keyframe_ids == [0, 3, 6]
    assert got.poses.shape == (N_FRAMES, 4, 4) and got.poses.dtype == np.float64
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-5)
    for a, b in zip(got.depths, want.depths):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    sv = StreamingVO(port, chunk_size=CHUNK, depth_dtype="float32")
    d_all, p_all = sv.run(frames)
    d_none, p_none = sv.run(frames, keep_depths=False)
    assert d_none == [] and len(d_all) == N_FRAMES
    np.testing.assert_array_equal(p_all, p_none)
    np.testing.assert_array_equal(got.positions, chain_relative_poses(p_all)[:, :3, 3])


class _PairOnly:
    """A runner that exposes only ``infer_coupled``: run_vo takes its
    per-pair loop."""

    def __init__(self, runner):
        self._runner = runner

    def infer_coupled(self, a, b):
        return self._runner.infer_coupled(a, b)


def test_per_pair_loop_matches_reference_and_stream(runners, frames):
    ref, port = runners
    got = run_vo(_PairOnly(port), frames, keyframe_every=2)
    want = jax_run_vo(_PairOnly(ref), frames, keyframe_every=2)
    stream = run_vo(port, frames, keyframe_every=2, chunk_size=CHUNK, depth_dtype="float32")
    assert got.keyframe_ids == want.keyframe_ids == stream.keyframe_ids == [0, 2, 4, 6]
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses, stream.poses, rtol=0, atol=1e-5)
    for a, b, c in zip(got.depths, want.depths, stream.depths):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="I420"):
        run_vo(_PairOnly(port), frames, input_format="i420")


def test_empty_stream():
    _, tcfg = _configs()
    runner = InferenceRunner(tcfg, ColVOModel(tcfg.model).state_dict(), device="cpu")
    depths, rel6 = StreamingVO(runner).run([])
    assert depths == [] and rel6.shape == (0, 6)
    vo = run_vo(runner, iter([]))
    np.testing.assert_array_equal(vo.poses, np.eye(4)[None])


@pytest.mark.parametrize("video_range", [True, False])
def test_rgb_to_i420_bit_equal_to_reference(video_range):
    u8 = np.random.default_rng(4).integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    got = rgb_to_i420(u8, video_range)
    assert got.dtype == np.uint8 and got.shape == (3, 96, 96)
    np.testing.assert_array_equal(got, jax_rgb_to_i420(u8, video_range))
    with pytest.raises(ValueError, match="I420"):
        rgb_to_i420(u8[:, :62])


@pytest.mark.parametrize("n, renorm_every", [(200, 50), (64, 0), (5, 1), (0, 50)])
def test_chain_matches_reference_and_numpy(n, renorm_every):
    """The native chain equals colvo's to 1e-12 and the plain numpy chain
    (SVD renormalisation against the native Gram–Schmidt) to 1e-12."""
    rel6 = 0.02 * np.random.default_rng(n).standard_normal((n, 6))
    got = chain_relative_poses(rel6, renorm_every=renorm_every)
    assert got.shape == (n + 1, 4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, jax_chain(rel6, renorm_every=renorm_every), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, chain_relative_poses_np(rel6, renorm_every), rtol=0, atol=1e-12)
    rot = got[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               rtol=0, atol=1e-12)


def test_missing_compiler_raises_without_fallback(monkeypatch, tmp_path):
    """A failed build of the native library raises in both of its callers;
    nothing drops to the numpy versions."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        chain_relative_poses(np.zeros((3, 6)))
    with pytest.raises(RuntimeError, match="no-such-g"):
        voxel_downsample(np.zeros((4, 3), np.float32), 0.01)
    assert native._lib is None


def test_native_first_use_from_many_threads(monkeypatch, tmp_path):
    """Threads that all reach the library's first use together build it
    once and chain the same poses (the fetch threads and the caller may)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    rel6 = 0.02 * np.random.default_rng(9).standard_normal((30, 6))
    want = chain_relative_poses_np(rel6)
    results, errors = [], []

    def worker():
        try:
            results.append(chain_relative_poses(rel6))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(results) == 12 and len(list((tmp_path / "_build").glob("*.so"))) == 1
    for got in results:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_native_rejects_malformed_arrays():
    with pytest.raises(ValueError):
        native.chain_poses(np.zeros((3, 3, 3)))
    with pytest.raises(ValueError):
        native.voxel_downsample(np.zeros((5, 2), np.float32), 0.1)
    with pytest.raises(ValueError):
        native.voxel_downsample(np.zeros((5, 3), np.float32), 0.1, np.zeros((4, 3)))
    with pytest.raises(ValueError):
        native.voxel_downsample(np.zeros((5, 3), np.float32), 0.0)


def test_native_library_name_follows_the_host_cpu(monkeypatch):
    """The library is built with -march=native, so two CPUs must never
    share one build: two CPU identities give two library paths, and one
    identity gives one."""
    paths = []
    for cpu in (b"-march=  skylake-avx512", b"-march=  znver4", b"-march=  skylake-avx512"):
        monkeypatch.setattr(native, "_cpu_identity", lambda cpu=cpu: cpu)
        paths.append(native._target())
    assert paths[0] != paths[1] and paths[0] == paths[2]
    assert all(p.parent == native.BUILD_DIR for p in paths)
    monkeypatch.undo()
    assert b"-march=" in native._cpu_identity()


@pytest.mark.parametrize("pair", ["run_vo", "StreamingVO.__init__", "StreamingVO.run"])
def test_signatures_match_the_reference(pair):
    """Parameter names, order, kinds and defaults equal colvo's, so that
    positional calls bind the same parameters (run_vo's fifth is the
    reference's unused batch_pairs)."""
    import inspect

    got, want = {
        "run_vo": (run_vo, jax_run_vo),
        "StreamingVO.__init__": (StreamingVO.__init__, JaxStreamingVO.__init__),
        "StreamingVO.run": (StreamingVO.run, JaxStreamingVO.run),
    }[pair]
    describe = lambda fn: [(p.name, p.kind, p.default)  # noqa: E731
                           for p in inspect.signature(fn).parameters.values()]
    assert describe(got) == describe(want)
