"""colvo_torch's CUDA kernels on a card, against their plain versions.

Marked ``cuda``; each test skips without a CUDA device. The file imports
no JAX, so on a machine without it run it without the suite's conftest,
from the repository root:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``.
"""

import os

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.config import ColvoConfig
from colvo_torch.kernels import fused_loss, sampler, scatter
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner
from colvo_torch.vo import StreamingVO


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coords(n, h, w, seed):
    """Smooth-ish random warps with out-of-bounds, ±1e20 and 3e9 coords."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    x = gx[None] + rng.normal(0, 8.0, (n, h, w)).astype(np.float32)
    y = gy[None] + rng.normal(0, 8.0, (n, h, w)).astype(np.float32)
    x[0, 1, 3], x[0, 2, 5], x[1, 5, 11] = 1e20, -1e20, 3e9
    y[0, 3, 7], y[0, 4, 9] = 1e20, -1e20
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
def test_kernels_match_plain_versions(device, c):
    """S (both variants): value ≤1e-5, d/dx, d/dy ≤1e-4 abs; T ≤1e-4 of
    max|d_src| (float atomics add in a run-dependent order)."""
    rng = np.random.default_rng(8)
    src = torch.tensor(rng.random((3, c, 40, 56), dtype=np.float32), device=device)
    x, y = (torch.tensor(a, device=device) for a in _coords(3, 36, 50, 9))
    for with_grad in (True, False):
        got = sampler.sample(src, x, y, with_grad)
        want = sampler.sample_plain(src, x, y, with_grad)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        for k, p in zip(got[1:], want[1:]):
            if with_grad:
                torch.testing.assert_close(k, p, atol=1e-4, rtol=0)
            else:
                assert k is None and p is None
    g = torch.randn((3, c, 36, 50), device=device)
    g[:, :, :4] = 0.0
    d = scatter.scatter(x, y, g, 40, 56)
    torch.testing.assert_close(d, scatter.scatter_plain(x, y, g, 40, 56),
                               atol=1e-4 * d.abs().max().item(), rtol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_autograd_goes_through_the_kernels(device):
    """The full-gradient sampler's forward is S with d/dx, d/dy and its
    backward T; gradients equal the CPU path's."""
    rng = np.random.default_rng(3)
    img = rng.random((2, 24, 32, 1), dtype=np.float32)
    x, y = _coords(2, 20, 28, 4)
    coords = np.stack([x, y], -1)
    kernels.reset_launch_counts()
    grads = {}
    for dev in (device, torch.device("cpu")):
        ti = torch.tensor(img, device=dev, requires_grad=True)
        tc = torch.tensor(coords, device=dev, requires_grad=True)
        torch.sum(torch.cos(3 * kernels.bilinear_sample_full(ti, tc))).backward()
        grads[dev.type] = (ti.grad.cpu(), tc.grad.cpu())
    assert kernels.launch_counts() == {"S/grad/C1": 1, "T/C1": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_cannot_launch(device):
    src = torch.zeros((1, 1, 4, 4), device=device, dtype=torch.float64)
    x = torch.zeros((1, 4, 4), device=device)
    with pytest.raises(TypeError):
        sampler.sample(src, x, x, True)
    with pytest.raises(ValueError):
        sampler.sample(src.float(), x.transpose(1, 2), x, True)
    with pytest.raises(ValueError):
        sampler.sample(torch.zeros((1, 2, 4, 4), device=device).transpose(2, 3), x, x, True)


def _geo_sets(device, seed, wild=False):
    """Depth planes and coords at three scales (one of an odd width), with
    a cotangent zeroed on a band; ``wild`` coords are uniform over the
    source, so no two neighbours' terms share a cell."""
    rng = np.random.default_rng(seed)
    sets = []
    for n, h, w in ((4, 64, 80), (4, 32, 40), (3, 37, 53)):
        d = torch.tensor(rng.random((n, 1, h, w), dtype=np.float32) + 0.01, device=device)
        if wild:
            x = rng.uniform(-2, w + 2, (n, h, w)).astype(np.float32)
            y = rng.uniform(-2, h + 2, (n, h, w)).astype(np.float32)
        else:
            x, y = _coords(n, h, w, seed + h)
        g = torch.tensor(rng.normal(size=(n, 1, h, w)).astype(np.float32), device=device)
        g[:, :, : h // 8] = 0.0
        sets.append((d, torch.tensor(x, device=device), torch.tensor(y, device=device), g))
    return [list(t) for t in zip(*sets)]


@pytest.mark.cuda
@pytest.mark.parametrize("wild", [False, True])
def test_multi_scale_kernels_match_plain_versions(device, wild):
    """The multi-plane-set S (grad and value) and T over three plane sets
    in one launch each: S value ≤1e-5, d/dx, d/dy ≤1e-4 abs; T ≤1e-4 of
    max|d_src|."""
    ds, xs, ys, gs = _geo_sets(device, 21, wild)
    kernels.reset_launch_counts()
    for with_grad in (True, False):
        got = sampler.sample_multi(ds, xs, ys, with_grad)
        want = sampler.sample_multi_plain(ds, xs, ys, with_grad)
        for k, p in zip(got, want):
            torch.testing.assert_close(k[0], p[0], atol=1e-5, rtol=0)
            if with_grad:
                for a, b in zip(k[1:], p[1:]):
                    torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
            else:
                assert k[1] is None and k[2] is None
    hws = [tuple(d.shape[2:]) for d in ds]
    for got, want in zip(scatter.scatter_multi(xs, ys, gs, hws),
                         scatter.scatter_multi_plain(xs, ys, gs, hws)):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"S/grad/C1": 1, "S/value/C1": 1, "T/C1": 1}


@pytest.mark.cuda
def test_multi_scale_autograd_launches_one_s_and_one_t(device):
    """bilinear_sample_full_multi over three plane sets: one S launch
    forward, one T launch backward, and gradients equal to the CPU path's;
    more sets than one launch takes go in several launches."""
    sets = _geo_sets(device, 31)
    kernels.reset_launch_counts()
    grads = {}
    for dev in (device, torch.device("cpu")):
        ds, xs, ys = ([t.detach().to(dev).requires_grad_(True) for t in ts] for ts in sets[:3])
        outs = kernels.bilinear_sample_full_multi(ds, xs, ys)
        sum(torch.sum(torch.cos(3 * o)) for o in outs).backward()
        grads[dev.type] = [t.grad.cpu() for t in ds + xs + ys]
    assert kernels.launch_counts() == {"S/grad/C1": 1, "T/C1": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    n = sampler.MAX_DESCS + 1
    kernels.reset_launch_counts()
    with torch.no_grad():
        outs = kernels.bilinear_sample_full_multi(sets[0][:1] * n, sets[1][:1] * n,
                                                  sets[2][:1] * n)
    assert len(outs) == n and all(torch.equal(o, outs[0]) for o in outs)
    assert kernels.launch_counts() == {"S/value/C1": 2}


def _same_bits(a, b):
    """Equal bit for bit, NaN matching NaN whatever its payload."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32),
                                                            b[~nan].view(torch.int32))


def _det_scatter(xs, ys, gs, hws):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return scatter.scatter_multi(xs, ys, gs, hws)
    finally:
        torch.use_deterministic_algorithms(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("wild", [False, True])
def test_deterministic_scatter_gives_the_same_bits_every_call(device, wild):
    """Under deterministic algorithms T launches its cluster kernel
    (T/C1/det, one count a plane-set launch): 10 calls give the same bits,
    those of ``scatter_plain_fixed`` on the card, within 1e-4 of max|d_src|
    of the plain version; outside the mode the float variant runs
    (T/C1)."""
    _, xs, ys, gs = _geo_sets(device, 41, wild)
    hws = [(64, 80), (32, 40), (37, 53)]
    kernels.reset_launch_counts()
    scatter.scatter_multi(xs, ys, gs, hws)
    assert kernels.launch_counts() == {"T/C1": 1}
    first = [d.clone() for d in _det_scatter(xs, ys, gs, hws)]
    for _ in range(9):
        for a, b in zip(_det_scatter(xs, ys, gs, hws), first):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert kernels.launch_counts() == {"T/C1": 1, "T/C1/det": 10}
    for got, fixed in zip(first, scatter.scatter_multi_plain_fixed(xs, ys, gs, hws)):
        assert _same_bits(got, fixed)
    for got, x, y, g, hw in zip(first, xs, ys, gs, hws):
        want = scatter.scatter_plain(x, y, g, *hw)
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
def test_deterministic_scatter_propagates_nan(device):
    """A NaN or inf cotangent, or a NaN coordinate, makes its plane NaN in
    the fixed-point variant (every cell of it); the other planes of the
    launch keep their values, bit for bit ``scatter_plain_fixed``; a zero
    cotangent gives a zero plane."""
    _, xs, ys, gs = _geo_sets(device, 43)
    gs[0][0, 0, 10, 10] = float("nan")
    gs[0][1, 0, 12, 3] = float("inf")
    gs[0][2].zero_()
    xs[1][0, 20, 20] = float("nan")
    hws = [(64, 80), (32, 40), (37, 53)]
    got = _det_scatter(xs, ys, gs, hws)
    assert torch.isnan(got[0][:2]).all() and torch.isnan(got[1][0]).all()
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    for d, fixed in zip(got, scatter.scatter_multi_plain_fixed(xs, ys, gs, hws)):
        assert _same_bits(d, fixed)
    for d, x, y, g, hw, keep in ((got[0], xs[0], ys[0], gs[0], hws[0], slice(3, 4)),
                                 (got[1], xs[1], ys[1], gs[1], hws[1], slice(1, None)),
                                 (got[2], xs[2], ys[2], gs[2], hws[2], slice(None))):
        want = scatter.scatter_plain(x[keep], y[keep], g[keep], *hw)
        torch.testing.assert_close(d[keep], want, atol=1e-4 * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
def test_deterministic_scatter_global_path(device):
    """A plane set whose source planes do not fit 8 CTAs' shared memory
    (512×640) takes the device-memory path (T/C1/det/global), beside one
    that takes the cluster kernel, in one call: both bit for bit
    ``scatter_plain_fixed``, the same bits over 5 calls, and inside a CUDA
    graph."""
    rng = np.random.default_rng(44)
    xs, ys, gs, hws = [], [], [], []
    for n, h, w, hs, ws in ((3, 256, 320, 512, 640), (4, 64, 80, 64, 80)):
        xs.append(torch.tensor(rng.uniform(-2, ws + 2, (n, h, w)).astype(np.float32), device=device))
        ys.append(torch.tensor(rng.uniform(-2, hs + 2, (n, h, w)).astype(np.float32), device=device))
        gs.append(torch.tensor(rng.normal(size=(n, 1, h, w)).astype(np.float32), device=device))
        hws.append((hs, ws))
    kernels.reset_launch_counts()
    first = [d.clone() for d in _det_scatter(xs, ys, gs, hws)]
    assert kernels.launch_counts() == {"T/C1/det": 1, "T/C1/det/global": 1}
    for _ in range(4):
        for a, b in zip(_det_scatter(xs, ys, gs, hws), first):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for got, fixed in zip(first, scatter.scatter_multi_plain_fixed(xs, ys, gs, hws)):
        assert _same_bits(got, fixed)
    graph = torch.cuda.CUDAGraph()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _det_scatter(xs, ys, gs, hws)  # warm
        with torch.cuda.graph(graph):
            outs = scatter.scatter_multi(xs, ys, gs, hws)
    finally:
        torch.use_deterministic_algorithms(prev)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, first):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_multi_scale_wrappers_reject_what_they_cannot_launch(device):
    ds, xs, ys, gs = _geo_sets(device, 41)
    hws = [tuple(d.shape[2:]) for d in ds]
    bad_x = [xs[0].transpose(1, 2).contiguous().transpose(1, 2)] + xs[1:]
    with pytest.raises(ValueError):
        sampler.sample_multi(ds, bad_x, ys, True)
    with pytest.raises(ValueError):
        scatter.scatter_multi(bad_x, ys, gs, hws)
    with pytest.raises(TypeError):
        sampler.sample_multi([ds[0].double()] + ds[1:], xs, ys, True)
    with pytest.raises(TypeError):
        scatter.scatter_multi(xs, ys, [gs[0].double()] + gs[1:], hws)
    with pytest.raises(ValueError):
        sampler.sample_multi(ds, xs[:2], ys, False)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4])
def test_grouped_sampler_matches_plain_version(device, group):
    """P6: plane i samples source i // group; value ≤1e-5, d/dx, d/dy ≤1e-4
    abs against the plain version on the repeated source. group=1 is the
    ungrouped launch, bit for bit."""
    rng = np.random.default_rng(11)
    src = torch.tensor(rng.random((3, 3, 40, 56), dtype=np.float32), device=device)
    x, y = (torch.tensor(a, device=device) for a in _coords(3 * group, 36, 50, 12))
    kernels.reset_launch_counts()
    for with_grad in (True, False):
        got = sampler.sample(src, x, y, with_grad, group)
        want = sampler.sample_plain(src, x, y, with_grad, group)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        if with_grad:
            for k, p in zip(got[1:], want[1:]):
                torch.testing.assert_close(k, p, atol=1e-4, rtol=0)
        if group == 1:
            for k, p in zip(got, sampler.sample(src, x, y, with_grad)):
                assert (k is None and p is None) or torch.equal(k, p)
    suffix = "" if group == 1 else f"/g{group}"
    assert kernels.launch_counts() == {
        f"S/grad/C3{suffix}": 1 + (group == 1), f"S/value/C3{suffix}": 1 + (group == 1)}


def _fused_inputs(device, c, seed, h=36, w=50):
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.random((2, c, h + 4, w + 6), dtype=np.float32), device=device)
    tgt = torch.tensor(rng.random((2, c, h, w), dtype=np.float32), device=device)
    x, y = (torch.tensor(a, device=device) for a in _coords(2, h, w, seed + 1))
    g = torch.tensor(rng.normal(size=(2, h, w)).astype(np.float32), device=device)
    g[:, :5] = 0.0
    return src, tgt, x, y, g


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("window", [0, 4, 15, 31])
@pytest.mark.parametrize("hw", [(36, 50), (150, 70)])
def test_fused_loss_matches_plain_versions(device, c, window, hw):
    """P7 e ≤1e-4 abs and P8 gx, gy ≤1e-3 of max|plain| against the plain
    versions (the window sums add in another order; E[w²]−μ² cancels under
    1/(var+1e-4)). Neither size is a multiple of the kernels' strips and
    row chunks, and 150 rows split into several row ranges; window 4 has
    lo ≠ hi, and window 31 is wider than the 36-row image."""
    src, tgt, x, y, g = _fused_inputs(device, c, 20 + c, *hw)
    e = fused_loss.err(src, tgt, x, y, window, 0.85)
    torch.testing.assert_close(e, fused_loss.err_plain(src, tgt, x, y, window, 0.85),
                               atol=1e-4, rtol=0)
    got = fused_loss.err_bwd(src, tgt, x, y, g, window, 0.85)
    want = fused_loss.err_bwd_plain(src, tgt, x, y, g, window, 0.85)
    for k, p in zip(got, want):
        torch.testing.assert_close(k, p, atol=1e-3 * p.abs().max().item(), rtol=0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_fused_loss_autograd_goes_through_the_kernels(device):
    """warp_photometric's forward is P7 and its backward P8, once each;
    the coordinate gradients equal the CPU path's and the frames get none."""
    src, tgt, x, y, _ = _fused_inputs(device, 3, 30)
    kernels.reset_launch_counts()
    out = {}
    for dev in (device, torch.device("cpu")):
        tx = x.to(dev, copy=True).requires_grad_(True)
        ty = y.to(dev, copy=True).requires_grad_(True)
        e = kernels.warp_photometric(src.to(dev), tgt.to(dev), tx, ty, "affine", 15, 0.85)
        torch.sum(torch.cos(4 * e)).backward()
        out[dev.type] = (e.detach().cpu(), tx.grad.cpu(), ty.grad.cpu())
    assert kernels.launch_counts() == {"F/fwd/C3": 1, "F/bwd/C3": 1}
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=0)
    for got, want in zip(out["cuda"][1:], out["cpu"][1:]):
        torch.testing.assert_close(got, want, atol=1e-3 * want.abs().max().item(), rtol=0)


@pytest.mark.cuda
def test_fused_and_grouped_wrappers_reject_what_they_cannot_launch(device):
    src, tgt, x, y, g = _fused_inputs(device, 3, 40)
    with pytest.raises(TypeError):
        fused_loss.err(src.double(), tgt, x, y, 15, 0.85)
    with pytest.raises(ValueError):
        fused_loss.err(src, tgt, x.transpose(1, 2).contiguous().transpose(1, 2), y, 15, 0.85)
    with pytest.raises(ValueError):
        fused_loss.err_bwd(src, tgt.transpose(2, 3).contiguous().transpose(2, 3), x, y, g, 15,
                           0.85)
    with pytest.raises(ValueError):
        fused_loss.err(src, tgt.cpu(), x, y, 15, 0.85)
    with pytest.raises(ValueError):
        sampler.sample(src, x, y, True, 4)  # 2 coordinate planes for 2 frames × 4


def _vo_runner(device):
    """An f32 runner at 64×96 over Flax-like random weights."""
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.data.height, cfg.data.width = 64, 96
    model = ColVOModel(cfg.model)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return InferenceRunner(cfg, model.state_dict(), device=device)


def _u8_frames(n, seed=0):
    """``n`` random uint8 frames at 64×96, made one at a time."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)


@pytest.mark.cuda
def test_stream_pinned_buffer_reuse_keeps_every_chunk(device):
    """20 chunks of 2 frames cycle the 8 pinned staging and wire buffers
    more than twice; depths and poses equal those of 2 chunks of 20 (conv
    rounding only: TF32 off, batch sizes differ)."""
    runner = _vo_runner(device)
    frames = list(_u8_frames(41, seed=1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        small = StreamingVO(runner, chunk_size=2, depth_dtype="float32", fetch_workers=1)
        assert small.max_in_flight == 8
        d2, p2 = small.run(frames)
        d20, p20 = StreamingVO(runner, chunk_size=20, depth_dtype="float32").run(frames)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert p2.shape == (40, 6) and len(d2) == 41
    np.testing.assert_allclose(p2, p20, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack(d2), np.stack(d20), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_stream_device_memory_flat_over_1000_frames(device):
    """keep_depths=False over 1000 frames peaks no higher on the device than
    over 200, and leaves nothing allocated behind."""
    runner = _vo_runner(device)
    sv = StreamingVO(runner, chunk_size=16)
    sv.run(_u8_frames(64), keep_depths=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}
    for n in (200, 1000):
        torch.cuda.reset_peak_memory_stats()
        depths, rel = sv.run(_u8_frames(n), keep_depths=False)
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated()
        assert depths == [] and rel.shape == (n - 1, 6) and np.isfinite(rel).all()
        assert torch.cuda.memory_allocated() == base
    assert peaks[1000] <= peaks[200]


def _host_batches(n, seed=5):
    """``n`` numpy batches shaped like the loader's, made one at a time;
    ``frames_clean`` is ``frames`` (no augmentation), as the loader gives."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        frames = rng.random((4, 3, 64, 96, 3), dtype=np.float32)
        yield {"frames": frames, "frames_clean": frames,
               "k": rng.random((3, 3), dtype=np.float32)}


@pytest.mark.cuda
def test_prefetcher_equals_the_numpy_stream_with_flat_memory(device):
    """50 batches through 2 slots arrive in order, equal to the numpy
    stream, while the consumer's stream is kept busy. Device memory is
    flat: over 10 batches and over 50 it peaks at no more than size + 3
    batches (the queue, the one the producer holds at its put, the one
    being yielded, and the one the consumer still holds until the yield
    rebinds its loop variable), and it is all freed after."""
    from colvo_torch.data import prefetch_to_device

    size = 2
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    per_batch = None
    for n in (10, 50):
        torch.cuda.reset_peak_memory_stats()
        want = _host_batches(n)
        count = 0
        for got in prefetch_to_device(_host_batches(n), size=size, device=device):
            torch.cuda._sleep(2_000_000)  # a step's worth of queued work
            ref = next(want)
            assert got["frames_clean"] is got["frames"]
            for key in ("frames", "k"):
                assert got[key].device.type == "cuda" and got[key].dtype == torch.float32
                np.testing.assert_array_equal(got[key].cpu().numpy(), ref[key])
            if per_batch is None:  # the allocator rounds each block to 512 bytes
                per_batch = sum(-(-t.numel() * t.element_size() // 512) * 512
                                for t in (got["frames"], got["k"]))
            count += 1
        del got  # the loop variable holds the last batch
        assert count == n
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= (size + 3) * per_batch, n
        assert torch.cuda.memory_allocated() == base


@pytest.mark.cuda
def test_async_logger_fetch_does_not_wait_for_later_steps(device, tmp_path):
    """The logger writes step k's row while the work of steps k+1..k+3 is
    still queued on the stream: its fetch waits on step k's own event."""
    import json
    import time

    from colvo_torch.runtime import AsyncMetricsLogger, MetricsWriter

    writer = MetricsWriter(str(tmp_path), also_stdout=False)
    logger = AsyncMetricsLogger(writer)
    loss = torch.full((), 0.25, device=device) * 2
    torch.cuda.synchronize()
    logger.log(1, {"loss/total": loss, "grad_norm": loss + 1})
    for _ in range(3):  # steps k+1..k+3: about a second of device time each
        torch.cuda._sleep(1_500_000_000)
    path = tmp_path / "metrics.jsonl"
    deadline = time.time() + 30
    while time.time() < deadline and not path.read_text():
        time.sleep(0.005)
    still_queued = not torch.cuda.current_stream().query()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    torch.cuda.synchronize()
    logger.close()
    assert rows and rows[0]["step"] == 1
    assert rows[0]["loss/total"] == 0.5 and rows[0]["grad_norm"] == 1.5
    assert still_queued


@pytest.mark.cuda
def test_snapshot_before_an_in_place_adam_step_restores_pre_step_values(device, tmp_path):
    """A snapshot queued behind a long kernel, then an in-place Adam step:
    the checkpoint holds the values from before the step."""
    from colvo_torch.runtime import CheckpointManager, TrainState

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Tanh(),
                                torch.nn.Linear(64, 8)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x = torch.randn((16, 64), device=device)
    for _ in range(2):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    state = TrainState(model, opt, 2, 10)

    def tensors(s):
        out = {f"m/{k}": v.detach().clone() for k, v in s.model.state_dict().items()}
        for i, st in s.optimizer.state_dict()["state"].items():
            out.update({f"o/{i}/{k}": v.detach().clone() for k, v in st.items()})
        return out

    before = tensors(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    torch.cuda._sleep(500_000_000)  # the snapshot's copies wait behind this
    mgr.save(2, state)
    opt.zero_grad()
    model(x).square().sum().backward()
    opt.step()  # in place, queued after the snapshot's copies
    mgr.wait()
    after = tensors(state)
    assert any(not torch.equal(after[k], before[k]) for k in before if k.startswith("m/"))
    fresh_model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.Tanh(),
                                      torch.nn.Linear(64, 8)).to(device)
    fresh = TrainState(fresh_model, torch.optim.Adam(fresh_model.parameters(), lr=1e-2), 0, 1)
    restored, step = mgr.restore(fresh)
    mgr.close()
    assert step == 2 and restored.step == 2
    got = tensors(restored)
    assert sorted(got) == sorted(before)
    for k in before:
        assert torch.equal(got[k].cpu(), before[k].cpu()), k


def _chunk_setup(device, n_steps=3):
    """A 64×96 f32 two-scale config with augmentation on, its store of one
    rendered 12-frame sequence (11 snippets), a state from seed 0 and its
    chunk of ``n_steps`` steps."""
    from colvo_torch.data import DeviceSnippetStore, render_sequence
    from colvo_torch.runtime import init_state, make_scan_train

    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    cfg.data.frame_offsets = (1,)
    seq = render_sequence(n_frames=12, height=64, width=96, seed=3)
    store = DeviceSnippetStore([seq.frames], [seq.k], cfg.data.frame_offsets, device=device)
    state = init_state(cfg, seed=0, device=device)
    return cfg, store, state, make_scan_train(state, cfg, n_steps)


@pytest.mark.cuda
def test_replayed_chunk_equals_eager_steps_on_the_same_draws(device):
    """The first call captures and replays: its indices are those an eager
    run draws from the same generator state, its launches are one geo S
    and one T a step plus the photometric S and two P each way a scale
    (the photometric and the geo grid), and its metrics equal 3 eager
    train_steps on the same batches and augmentation draws from the same
    weights (TF32 off): step 1's terms to 1e-5 relative and grad_norm to
    1e-4 (T adds with atomics, in another order each run); the loss terms
    of steps 2 and 3 at the reference's widening tolerances for equivalent
    programs run apart (1e-3, 1e-2; tests/test_device_store.py:149-152).
    grad_norm after step 1 is not compared: the two runs' weights then
    differ in their last bits, and a near-tie automask decision that
    comes out the other way moves it by ~2e-3 (PERF.md §6)."""
    from colvo_torch.data.device_store import device_augment, gather
    from colvo_torch.runtime import init_state, train_step

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg, store, state, chunk = _chunk_setup(device)
        eager_state = init_state(cfg, seed=0, device=device)
        gen = torch.Generator(device=device).manual_seed(3)
        rng = gen.get_state()
        state, metrics = chunk(state, store.frames, store.table, store.k, gen)
        assert chunk.graph is not None and state.step == 3 and int(chunk.step) == 3
        assert chunk.captured_launches == {"S/grad/C3": 6, "S/grad/C1": 3, "T/C1": 3,
                                           "P/fwd": 12, "P/bwd": 12}
        replay = torch.Generator(device=device)
        replay.set_state(rng)
        eager = []
        for i in range(3):
            idx = torch.randint(0, store.n_snippets, (2,), generator=replay, device=device)
            assert torch.equal(idx, chunk.indices[i]), i
            aug, clean = device_augment(gather(store.frames, store.table, idx), replay, cfg.data)
            eager.append(train_step(eager_state, {"frames": aug, "frames_clean": clean,
                                                  "k": store.k}, cfg))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for i, want in enumerate(eager):
        for key, v in want.items():
            if key == "grad_norm" and i > 0:
                continue
            tol = (1e-4 if key == "grad_norm" else 1e-5, 1e-3, 1e-2)[i]
            torch.testing.assert_close(metrics[key][i], v, rtol=tol, atol=1e-7,
                                       msg=lambda m, k=key, s=i + 1: f"{k} at step {s}: {m}")
    assert torch.equal(gen.get_state(), replay.get_state())


@pytest.mark.cuda
def test_chunk_replays_keep_device_memory_flat(device):
    """After the capture, 50 replays peak no higher than 10 and leave no
    more allocated than before them."""
    _, store, state, chunk = _chunk_setup(device, n_steps=2)
    gen = torch.Generator(device=device).manual_seed(0)
    chunk(state, store.frames, store.table, store.k, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peaks = {}
    for n in (10, 50):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            _, metrics = chunk(state, store.frames, store.table, store.k, gen)
        assert torch.isfinite(metrics["loss/total"]).all()
        del metrics
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated()
        assert torch.cuda.memory_allocated() == base
    assert peaks[50] <= peaks[10]
    assert state.step == 2 * 61


@pytest.mark.cuda
def test_two_replays_draw_different_indices_from_the_registered_generator(device):
    """Each replay advances the generator registered with the graph, so
    successive chunks train on other snippets; a chunk refuses inputs other
    than those it was captured with."""
    _, store, state, chunk = _chunk_setup(device)
    gen = torch.Generator(device=device).manual_seed(0)
    chunk(state, store.frames, store.table, store.k, gen)
    drawn = []
    for _ in range(2):
        before = gen.get_state()
        chunk(state, store.frames, store.table, store.k, gen)
        drawn.append(chunk.indices.clone())
        assert not torch.equal(gen.get_state(), before)
    assert not torch.equal(drawn[0], drawn[1])
    assert all(0 <= int(i) < store.n_snippets for d in drawn for i in d.flatten())
    with pytest.raises(ValueError, match="captured with"):
        chunk(state, store.frames.clone(), store.table, store.k, gen)


@pytest.mark.cuda
def test_png_codec_on_a_card_host_without_cv2(device, tmp_path, monkeypatch):
    """The card's host has no cv2 or PIL: PNG frames (8-bit RGB, 16-bit
    gray) round-trip through the port's codec and native unfilter, and a
    frame source reads and resizes them."""
    import sys

    from colvo_torch.data import png, sources

    monkeypatch.setitem(sys.modules, "cv2", None)
    rgb = next(_u8_frames(1, seed=3))
    g16 = np.random.default_rng(4).integers(0, 65536, (64, 96)).astype(np.uint16)
    png.write_png(str(tmp_path / "000000.png"), rgb)
    png.write_png(str(tmp_path / "depth.png"), g16)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "000000.png")), rgb)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "depth.png")), g16)
    src = sources.FrameDirSource(str(tmp_path), 48, 32, "i420")
    assert src[0].shape == (48, 48) and src[0].dtype == np.uint8


@pytest.mark.cuda
def test_cli_vo_on_the_card_without_cv2(device, tmp_path, monkeypatch):
    """``cli vo`` on a PNG frame dir (a ×1.5 area resize), on the card by
    default, with cv2 absent: a trajectory of orthonormal rotations, the
    PLY and both figures; no S, T or F launch."""
    import sys

    from colvo_torch import cli
    from colvo_torch.data import png, render_sequence
    from colvo_torch.vo import load_ply

    monkeypatch.setitem(sys.modules, "cv2", None)
    seq = render_sequence(n_frames=9, height=96, width=144, seed=5)
    os.makedirs(tmp_path / "frames")
    for i, f in enumerate(seq.frames):
        png.write_png(str(tmp_path / "frames" / f"{i:06d}.png"),
                      np.clip(f * 255 + 0.5, 0, 255).astype(np.uint8))
    kernels.reset_launch_counts()
    out = str(tmp_path / "vo")
    assert cli.main(["vo", str(tmp_path / "frames"), "--out", out, "--data.height=64",
                     "--data.width=96"]) == 0
    poses = np.load(os.path.join(out, "trajectory.npy"))
    rot = poses[:, :3, :3]
    assert poses.shape == (9, 4, 4) and np.isfinite(poses).all()
    assert np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max() <= 1e-9
    assert len(load_ply(os.path.join(out, "reconstruction.ply"))) > 0
    assert png.read_png(os.path.join(out, "reconstruction.png")).shape == (780, 1040, 3)
    assert png.read_png(os.path.join(out, "trajectory.png")).shape == (780, 910, 3)
    assert kernels.launch_counts() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["model.remat", "train.adam_mu_dtype"])
def test_chunk_captures_under_remat_and_the_bf16_moment(device, knob):
    """make_scan_train captures and replays under model.remat (with
    loss.photo_remat: checkpointed blocks in the graph) and under
    adam_mu_dtype="bfloat16" (the port's Adam): finite losses, the first
    moments bf16 under the latter, and a second replay that trains on."""
    from colvo_torch.data import DeviceSnippetStore, render_sequence
    from colvo_torch.runtime import init_state, make_scan_train

    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    cfg.data.frame_offsets = (1,)
    if knob == "model.remat":
        cfg.model.remat = cfg.loss.photo_remat = True
    else:
        cfg.train.adam_mu_dtype = "bfloat16"
    seq = render_sequence(n_frames=12, height=64, width=96, seed=3)
    store = DeviceSnippetStore([seq.frames], [seq.k], cfg.data.frame_offsets, device=device)
    state = init_state(cfg, seed=0, device=device)
    chunk = make_scan_train(state, cfg, 2)
    gen = torch.Generator(device=device).manual_seed(0)
    state, m1 = chunk(state, store.frames, store.table, store.k, gen)
    state, m2 = chunk(state, store.frames, store.table, store.k, gen)
    assert chunk.graph is not None and state.step == 4
    assert torch.isfinite(m1["loss/total"]).all() and torch.isfinite(m2["loss/total"]).all()
    assert chunk.captured_launches == {"S/grad/C3": 4, "S/grad/C1": 2, "T/C1": 2,
                                       "P/fwd": 8, "P/bwd": 8}
    if knob == "train.adam_mu_dtype":
        moments = [state.optimizer.state[p]["exp_avg"] for p in state.model.parameters()]
        assert all(m.dtype == torch.bfloat16 for m in moments)


@pytest.mark.cuda
def test_one_rank_nccl_group_all_reduces_and_the_mesh_is_one(device, monkeypatch):
    """``maybe_init_distributed`` under a launcher's variables joins a
    one-rank NCCL group; its all-reduce (SUM) is the identity, bit for bit,
    on the loss's global sum and on the flat gradient all-reduce."""
    import socket

    from colvo_torch.runtime import mesh as mesh_mod

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for var, value in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(var, value)
    assert mesh_mod.maybe_init_distributed()
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = mesh_mod.make_mesh()
        assert (mesh.size, mesh.rank) == (1, 0)
        g = torch.Generator(device=device).manual_seed(0)
        grads = [torch.randn((7, 5), device=device, generator=g),
                 torch.randn((3,), device=device, generator=g)]
        before = [x.clone() for x in grads]
        mesh.all_reduce_grads(grads)
        assert all(torch.equal(a, b) for a, b in zip(grads, before))
        x = torch.randn((1000,), device=device, generator=g)
        y = x.sum().clone()
        torch.distributed.all_reduce(y)
        assert torch.equal(y, x.sum())
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_refine_with_kernel_s_matches_the_plain_sampler(device):
    """``refine_keyframe_poses`` on the card through kernel S (2 launches
    with d/dx, d/dy an iteration, 4 value-only a batch; two batches of one
    shape: one warm-up call, then two replays of the captured program)
    against the same call with the sampler's plain version, captured anew:
    poses to 1e-4."""
    from unittest import mock

    from colvo_torch.data.synthetic import default_intrinsics, make_trajectory, render_frame
    from colvo_torch.vo.refine import _refine, refine_keyframe_poses

    h, w, iters = 64, 96, 5
    k = default_intrinsics(h, w)
    gt = make_trajectory(8, step=0.004, wobble=0.3, seed=31).astype(np.float64)
    ids = [0, 2, 4, 6]
    frames, depths = zip(*(render_frame(gt[i], k, h, w, radius=0.03) for i in ids))
    kw = dict(keyframe_ids=ids, depths=[d.astype(np.float32) for d in depths],
              frames_kf=np.stack(frames).astype(np.float32), k=k, iters=iters, lr=2e-3,
              batch=2, device=device)
    _refine.programs.clear()
    kernels.reset_launch_counts()
    got, _ = refine_keyframe_poses(gt, **kw)
    counts = kernels.launch_counts()
    assert counts == {"S/grad/C3": 3 * iters, "S/grad/C1": 3 * iters, "S/value/C3": 6,
                      "S/value/C1": 6}, counts
    _refine.programs.clear()  # a program holds the kernels it captured
    try:
        with mock.patch.object(sampler, "sample", sampler.sample_plain):
            want, _ = refine_keyframe_poses(gt, **kw)
    finally:
        _refine.programs.clear()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "float16", "uint8"])
def test_captured_chunk_step_equals_its_eager_body_bit_for_bit(device, wire):
    """At 64×96: the replayed ``chunk_step`` (and ``init_step``) give the
    wire and the carry of the eager body on the same inputs, bit for bit;
    a second chunk replays the same graph."""
    runner = _vo_runner(device)
    vo = StreamingVO(runner, chunk_size=4, depth_dtype=wire)
    frames = torch.from_numpy(np.stack(list(_u8_frames(9, seed=2)))).to(device)
    from colvo_torch.vo.stream import _chunk_body, _init_body
    with torch.inference_mode():
        d0, ci, cb = (x.clone() for x in vo.init_step(frames[:1]))
        e0, ei, eb = _init_body(runner, frames[:1], input_format="rgb")
        assert all(torch.equal(a, b) for a, b in ((d0, e0), (ci, ei), (cb, eb)))
        for lo in (1, 5):
            chunk = frames[lo:lo + 4]
            want = vo.chunk_body(ci, cb, chunk)
            got = vo.chunk_step(ci, cb, chunk)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
            ci, cb = got[1].clone(), got[2].clone()
    assert len(runner.program(_chunk_body).programs) == 1


_DET_CHILD = """
import torch
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
from colvo_torch.runtime import init_state, make_train_step, to_device, train_step
from colvo_torch.runtime.loop import deterministic_mode

cfg = ColvoConfig()
cfg.model.n_scales = 2
cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
seq = render_sequence(n_frames=8, height=64, width=96, seed=3)
it = batch_iterator(SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data,
                    seed=0)
dev = torch.device("cuda")
with deterministic_mode(True):
    eager = init_state(cfg, seed=0, device=dev)
    graphed = init_state(cfg, seed=0, device=dev)
    step_fn = make_train_step(graphed, cfg)
    for i in range(3):
        batch = to_device(next(it), dev)
        want = train_step(eager, batch, cfg)
        got = step_fn(graphed, batch)
        assert all(torch.equal(got[k], v) for k, v in want.items()), i
    for p, q in zip(eager.model.parameters(), graphed.model.parameters()):
        assert torch.equal(p, q)
        a, b = eager.optimizer.state[p], graphed.optimizer.state[q]
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
print("deterministic steps equal", flush=True)
"""


@pytest.mark.cuda
def test_three_deterministic_captured_steps_equal_three_eager_ones(device):
    """Under ``train.deterministic``, in a fresh process (cuBLAS reads its
    workspace setting when its handle is made): 3 replays of the captured
    step give the metrics, weights and Adam moments of 3 eager
    ``train_step`` calls, bit for bit (T's fixed-point cluster kernel
    inside the graph)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _DET_CHILD], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "deterministic steps equal" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("augment", [True, False])
def test_captured_batch_program_equals_eager_gather_and_augment(device, augment):
    """At 64×96, B=2, over an epoch and a half: each batch of the store (a
    replay of its program, the generator registered) equals the eager
    gather + ``device_augment`` from the same seed's permutation and
    generator, bit for bit; the program was captured once and launches no
    kernel of ours."""
    from colvo_torch.config import DataConfig
    from colvo_torch.data import DeviceSnippetStore, device_augment, render_sequence
    from colvo_torch.data.device_store import gather

    cfg = DataConfig(height=64, width=96, batch_size=2, augment=augment)
    seq = render_sequence(n_frames=10, height=64, width=96, seed=4)
    store = DeviceSnippetStore([seq.frames], [seq.k], device=device)
    it = store.batches(cfg, seed=7)
    kernels.reset_launch_counts()
    n = store.n_snippets // 2
    got = [{k: v.clone() for k, v in next(it).items()} for _ in range(n + n // 2)]
    assert kernels.launch_counts() == {}
    assert len(store.program.programs) == 1
    assert all(p.graph is not None for p in store.program.programs.values())
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=device).manual_seed(7)
    i = 0
    while i < len(got):
        order = torch.from_numpy(rng.permutation(store.n_snippets)).to(device)
        for s in range(0, store.n_snippets - 1, 2):
            if i == len(got):
                break
            clean = gather(store.frames, store.table, order[s:s + 2])
            aug, clean = device_augment(clean, gen, cfg) if augment else (clean, clean)
            assert torch.equal(got[i]["frames"], aug) and torch.equal(
                got[i]["frames_clean"], clean), i
            i += 1


@pytest.mark.cuda
def test_captured_eval_forward_equals_its_eager_body(device):
    """The eval hook's program at 64×96 (bf16 convs) against its eager body
    on the same weights: every output bit for bit at the capture's call and
    at a replay after the weights changed in place; no kernel of ours
    launched (its warp is the plain sampler)."""
    import types

    from colvo_torch.pipelines import make_training_eval_hook

    cfg = ColvoConfig()
    cfg.data.height, cfg.data.width = 64, 96
    model = ColVOModel(cfg.model)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    hook = make_training_eval_hook(cfg, model)
    state = types.SimpleNamespace(model=model)
    kernels.reset_launch_counts()
    for step in range(2):
        scalars = hook(step, state, None)
        assert all(np.isfinite(v) for v in scalars.values())
        got = [t.clone() for t in hook.program()]
        model.eval()
        want = hook.forward(model)
        model.train()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), step
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.01)
    assert kernels.launch_counts() == {}
    assert len(hook.program.programs) == 1


@pytest.mark.cuda
def test_captures_leave_no_memory_behind(device):
    """Every capture warms up on its device's one side stream: ten
    programs of a cuBLAS body captured and dropped leave the card's
    allocated memory where the first left it (with a stream of their own,
    the libraries' per-stream state stayed allocated after each)."""
    import gc

    from colvo_torch.runtime import graphs

    w = torch.randn(256, 256, device=device)
    x = torch.randn(64, 256, device=device)

    def capture_once():
        prog = graphs.Graphed(lambda a: (a @ w).relu() @ w, device=device)
        prog(x)
        del prog
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(device)

    first = capture_once()
    assert [capture_once() for _ in range(10)] == [first] * 10


@pytest.mark.cuda
def test_ablation_cell_launches_its_steps_and_its_resume_none(device, tmp_path, monkeypatch):
    """``ablate.run_cell`` at 64×96, B=2, 3 steps on a corpus of 2 × 6
    frames: the captured step's launches (8 S/grad/C3, one S/grad/C1 for
    the four geo scales, one T/C1, 8 P/fwd and 8 P/bwd: the photometric
    and the geo grid of each scale) × (3 replays + the warm-up), none in
    the export and evaluation; resumed, the cell returns its record and
    launches nothing."""
    import sys
    from unittest import mock

    from colvo_torch.runtime import graphs
    from colvo_torch.scripts import ablate

    def small():
        cfg = ColvoConfig()
        cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
        return cfg

    # blocks TensorBoard's import (it loads TensorFlow); no other module is dropped after
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with mock.patch.object(ablate, "ColvoConfig", small), \
            mock.patch.object(ablate, "N_SEQUENCES", 2), mock.patch.object(ablate, "N_FRAMES", 6):
        kernels.reset_launch_counts()
        rec = ablate.run_cell(True, True, 3, str(tmp_path), device="cuda")
        n = 3 + graphs.WARMUP
        assert kernels.launch_counts() == {"S/grad/C3": 8 * n, "S/grad/C1": n, "T/C1": n,
                                           "P/fwd": 8 * n, "P/bwd": 8 * n}
        assert np.isfinite(rec["abs_rel"]) and np.isfinite(rec["polyp/e_mean"])
        kernels.reset_launch_counts()
        assert ablate.run_cell(True, True, 3, str(tmp_path), device="cuda") == rec
        assert kernels.launch_counts() == {}


# The training cell's grids (B = 12, two sources): the photometric grid and
# the geo grids of the four scales.
CELL_B, CELL_GRIDS = 12, ((256, 320), (128, 160), (64, 80), (32, 40))


def _project_inputs(device, b, h, w, seed, n_sources=2):
    """depth (B, h, w) from uniform disparities (``disp_to_depth``), a
    per-row K for an h×w grid and its inverse, small poses as the loss makes
    them, transposed to (S, B, 4, 4), and cotangents of x, y, z."""
    from colvo_torch.data.synthetic import default_intrinsics
    from colvo_torch.geometry import disp_to_depth, transformation_from_parameters

    rng = np.random.default_rng(seed)
    disp = torch.tensor(rng.uniform(0.02, 0.98, (b, h, w)).astype(np.float32))
    depth = disp_to_depth(disp)[1]
    k = torch.tensor(default_intrinsics(h, w)).repeat(b, 1, 1)
    k[:, 0, 2] += torch.tensor(rng.uniform(-2, 2, b).astype(np.float32))
    poses = torch.tensor(rng.normal(0, 0.02, (b, n_sources, 6)).astype(np.float32))
    t = transformation_from_parameters(poses[..., :3], poses[..., 3:]).transpose(0, 1)
    g = torch.tensor(rng.normal(size=(3, n_sources * b, h, w)).astype(np.float32))
    return [a.to(device) for a in (depth, k, torch.linalg.inv(k), t, *g.unbind(0))]


def _grid_close(got, want, rel):
    """got, want (A, N, B) for N grids: |got − want| ≤ rel·(|want| + the
    largest |want| of its grid)."""
    got, want = got.float(), want.float()
    err = (got - want).abs() - rel * (want.abs() + want.abs().amax(dim=(0, 2), keepdim=True))
    assert torch.isfinite(got).all()
    assert (err <= 0).all(), f"{int((err > 0).sum())} cells off, by up to {err.max().item():.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("hw", CELL_GRIDS, ids=[f"{h}x{w}" for h, w in CELL_GRIDS])
def test_project_kernel_matches_the_plain_path_at_the_cells_shapes(device, hw):
    """P at the training cell's grids (B = 12, two sources, K by row):
    x, y, z within 1e-5 and d_depth, d_T within 1e-4 of autograd through
    ``ops.project(ops.backproject(...))`` in float64 on the card, each
    relative to the value and to the largest of its grid; one launch each
    way."""
    from colvo_torch.kernels import project

    depth, k, k_inv, t, gx, gy, gz = _project_inputs(device, CELL_B, *hw, 11)
    kernels.reset_launch_counts()
    d, tt = depth.clone().requires_grad_(), t.clone().requires_grad_()
    got = kernels.project_depth(d, k, k_inv, tt)
    (sum((o * g).sum() for o, g in zip(got, (gx, gy, gz)))).backward()
    assert kernels.launch_counts() == {"P/fwd": 1, "P/bwd": 1}
    d64, t64 = depth.double().requires_grad_(), t.double().requires_grad_()
    want = project.project_plain(d64, k.double(), k_inv.double(), t64)
    (sum((o * g.double()).sum() for o, g in zip(want, (gx, gy, gz)))).backward()
    for o, w in zip(got, want):
        _grid_close(o.detach().reshape(2, CELL_B, -1), w.detach().reshape(2, CELL_B, -1), 1e-5)
    _grid_close(d.grad.reshape(1, CELL_B, -1), d64.grad.reshape(1, CELL_B, -1), 1e-4)
    _grid_close(tt.grad.reshape(2, CELL_B, -1), t64.grad.reshape(2, CELL_B, -1), 1e-4)
    assert torch.equal(tt.grad[:, :, 3], torch.zeros_like(tt.grad[:, :, 3]))


@pytest.mark.cuda
def test_project_backward_gives_the_same_bits_twice(device):
    """Two backward passes of P at the full-resolution grid on the same
    inputs give d_depth and d_T bit for bit (no float atomics)."""
    depth, k, k_inv, t, gx, gy, gz = _project_inputs(device, CELL_B, *CELL_GRIDS[0], 12)
    grads = []
    for _ in range(2):
        d, tt = depth.clone().requires_grad_(), t.clone().requires_grad_()
        x, y, z = kernels.project_depth(d, k, k_inv, tt)
        ((x * gx).sum() + (y * gy).sum() + (z * gz).sum()).backward()
        grads.append((d.grad, tt.grad))
    for a, b in zip(*grads):
        assert _same_bits(a, b)


# loss knobs of the snippet-loss test and P's launches each way a step
# (grids: the photometric one of each scale; a geo grid of its own unless
# the geo term reuses it; under "sym" the reverse warps' grid besides)
LOSS_KNOBS = {
    "default": ({}, 8),
    "geo_grad=sym": ({"geo_grad": "sym"}, 12),
    "photo_native": ({"photo_native": True}, 4),
    "geo_full_res": ({"geo_full_res": True}, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("knob", list(LOSS_KNOBS))
def test_snippet_loss_with_p_matches_the_cpu_plain_path(device, knob):
    """``snippet_loss`` at 64×96, B = 2, four scales, two sources, on one
    set of disparities and poses from a float32 model: on the card (P, S
    and T) the loss terms within 1e-4 relative and the gradients of the
    disparities and poses within 1e-3 of their norm of the CPU's plain
    path (S's and T's sums, and near-tie min-reprojection choices, differ
    in their last bits), with P launched as the knob's grids give it."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.losses import snippet_loss
    from colvo_torch.runtime import init_state, to_device

    knobs, launches = LOSS_KNOBS[knob]
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    for key, v in knobs.items():
        setattr(cfg.loss, key, v)
    seq = render_sequence(n_frames=8, height=64, width=96, seed=4)
    batch = to_device(next(batch_iterator(
        SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data, seed=0)),
        torch.device("cpu"))
    state = init_state(cfg, seed=0, device=torch.device("cpu"))
    with torch.no_grad():
        disps, poses = state.model(batch["frames"])
    results = {}
    for dev in (device, torch.device("cpu")):
        ds = [{s: v.detach().to(dev).requires_grad_() for s, v in f.items()} for f in disps]
        ps = poses.detach().to(dev).requires_grad_()
        k = batch["k"].to(dev)
        kernels.reset_launch_counts()
        loss, aux = snippet_loss(ds, ps, batch["frames"].to(dev), k, torch.linalg.inv(k),
                                 cfg.loss, cfg.model, frames_clean=batch["frames_clean"].to(dev))
        loss.backward()
        if dev.type == "cuda":
            counts = kernels.launch_counts()
            assert counts["P/fwd"] == counts["P/bwd"] == launches, counts
        terms = {key: v.item() for key, v in aux.items() if v.dim() == 0}
        grads = [torch.cat([v.grad.flatten() for f in ds for v in f.values()]), ps.grad.flatten()]
        results[dev.type] = terms, [g.cpu() for g in grads]
    (got_t, got_g), (want_t, want_g) = results["cuda"], results["cpu"]
    for key, v in want_t.items():
        assert abs(got_t[key] - v) <= 1e-4 * max(abs(v), 1e-6), (key, got_t[key], v)
    for got, want in zip(got_g, want_g):
        assert (got - want).norm() <= 1e-3 * want.norm(), ((got - want).norm(), want.norm())


# Operators that lower to a cuBLAS GEMM, as the profiler names them.
GEMM_OPS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::baddbmm", "aten::matmul",
            "aten::einsum")


@pytest.mark.cuda
def test_captured_default_step_projects_through_p_alone(device):
    """The default loss at 64×96, B = 2 (four scales, two sources): a replay
    of the captured step launches P 8 times each way (one a grid: the
    photometric and the geo grid of each scale), beside its S and T; the
    eager step under ``torch.profiler`` runs no GEMM operator with a
    pixel axis (the smallest grid's 384 pixels or more), so no cuBLAS
    float32 GEMM comes from the projection."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.runtime import init_state, make_train_step, to_device, train_step

    cfg = ColvoConfig()
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    seq = render_sequence(n_frames=8, height=64, width=96, seed=3)
    it = batch_iterator(SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data,
                        seed=0)
    batches = [to_device(next(it), device) for _ in range(3)]
    state = init_state(cfg, seed=0, device=device)
    step_fn = make_train_step(state, cfg)
    step_fn(state, batches[0])
    kernels.reset_launch_counts()
    step_fn(state, batches[1])
    assert kernels.launch_counts() == {"P/fwd": 8, "P/bwd": 8, "S/grad/C3": 8, "S/grad/C1": 1,
                                       "T/C1": 1}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        train_step(state, batches[2], cfg)
        torch.cuda.synchronize()
    pixel_gemms = [(e.name, e.input_shapes) for e in prof.events() if e.name in GEMM_OPS
                   and any(dim >= 16 * 24 for shape in e.input_shapes for dim in shape)]
    assert not pixel_gemms, pixel_gemms
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("project_depth_kernel" in n for n in names), sorted(names)[:40]


# A small Depth Anything V2 preset (``models/vit.py``'s table), every width
# but the ViT's and the head's as published.
DPT_TINY = dict(dim=64, depth=4, heads=4, taps=(0, 1, 2, 3), features=16,
                out_channels=(8, 16, 32, 32))


def _dpt_setup(device, monkeypatch):
    """A bf16 DPT configuration at 56×70, B = 2, and three device batches."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.models import vit
    from colvo_torch.runtime import to_device

    monkeypatch.setitem(vit.PRESETS, "dpt_tiny14", DPT_TINY)
    cfg = ColvoConfig()
    cfg.model.depth_net, cfg.model.n_scales, cfg.model.dcdp_fusion = "dpt_tiny14", 1, False
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 56, 70, 2
    seq = render_sequence(n_frames=8, height=56, width=70, seed=3)
    it = batch_iterator(SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data,
                        seed=0)
    return cfg, [to_device(next(it), device) for _ in range(3)]


@pytest.mark.cuda
def test_captured_dpt_step_equals_the_eager_step(device, monkeypatch):
    """With TF32 off, two replays of the captured DPT step against two eager
    ``train_step`` calls, each from the same weights and Adam state (the
    eager side's, copied into the captured one's tensors after each step):
    the loss terms bit for bit (the same forward kernels), the gradient's
    norm within 1e-3 relative and the weights after the step within 2·lr
    (FlashAttention's and the bilinear upsample's backwards sum in a
    run-dependent order, and Adam's first steps move a weight by about
    ±lr); a replay launches 4 attention calls, one a block."""
    from colvo_torch.runtime import init_state, make_train_step, train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg, batches = _dpt_setup(device, monkeypatch)
    eager, graphed = (init_state(cfg, seed=0, device=device) for _ in range(2))
    step_fn = make_train_step(graphed, cfg)
    for i, batch in enumerate(batches[:2]):
        kernels.reset_launch_counts()
        got = {k: v.clone() for k, v in step_fn(graphed, batch).items()}
        if i == 1:
            assert kernels.launch_counts().get("attn/fwd") == 4, kernels.launch_counts()
        want = train_step(eager, batch, cfg)
        for key in ("loss/total", "loss/photometric", "loss/smoothness", "loss/geometric"):
            assert torch.equal(got[key], want[key]), (i, key)
        torch.testing.assert_close(got["grad_norm"], want["grad_norm"], rtol=1e-3, atol=0)
        pairs = list(zip(eager.model.named_parameters(), graphed.model.parameters()))
        with torch.no_grad():
            for (name, p), q in pairs:
                assert (p - q).abs().max() <= 2 * cfg.train.lr, (i, name)
                q.copy_(p)
                for key, v in eager.optimizer.state[p].items():
                    graphed.optimizer.state[q][key].copy_(v)
    assert graphed.step == eager.step == 2


@pytest.mark.cuda
def test_dpt_attention_takes_a_fused_kernel_never_math(device, monkeypatch):
    """A profiled eager DPT step runs attention through FlashAttention,
    cuDNN's or the memory-efficient kernel, forward and backward, and
    never the math backend's operator; an input no fused kernel takes
    (float64) raises instead of falling back."""
    from colvo_torch.runtime import init_state, train_step

    cfg, batches = _dpt_setup(device, monkeypatch)
    state = init_state(cfg, seed=0, device=device)
    train_step(state, batches[0], cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(state, batches[1], cfg)
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events()}
    fused = {"aten::_scaled_dot_product_flash_attention",
             "aten::_scaled_dot_product_cudnn_attention",
             "aten::_scaled_dot_product_efficient_attention"}
    assert ops & fused, sorted(o for o in ops if "attention" in o)
    assert "aten::_scaled_dot_product_attention_math" not in ops
    names = [e.name.lower() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(k in n for n in names for k in ("flash", "fmha", "sdpa")), sorted(set(names))[:40]
    q = torch.randn(2, 4, 9, 16, device=device, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        kernels.attention(q, q, q)


@pytest.mark.cuda
def test_a_capture_that_reads_the_card_on_the_host_raises(device):
    """A step whose body reads a device value on the host (``.item()``)
    cannot be captured: ``make_train_step`` raises rather than running it
    eagerly, and no program is kept. Last in the file: a failed capture
    may leave its stream unusable."""
    import importlib
    from unittest import mock

    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.runtime import init_state, make_train_step, to_device

    cfg = ColvoConfig()
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    seq = render_sequence(n_frames=6, height=64, width=96, seed=3)
    batch = to_device(next(batch_iterator(
        SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data, seed=0)),
        device)
    state = init_state(cfg, seed=0, device=device)
    step_fn = make_train_step(state, cfg)
    # the module (``colvo_torch.runtime.train_step`` names the function)
    ts = importlib.import_module("colvo_torch.runtime.train_step")
    real_clip = ts.clip_by_global_norm

    def clip_reading_the_norm(grads, max_norm):
        norm = real_clip(grads, max_norm)
        norm.item()
        return norm

    with mock.patch.object(ts, "clip_by_global_norm", clip_reading_the_norm):
        with pytest.raises(RuntimeError):
            step_fn(state, batch)
    assert state.step == 0
    assert all(p.graph is None for p in step_fn.program.programs.values())
