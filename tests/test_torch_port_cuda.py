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
from colvo_torch.losses.photometric import warp_photometric
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
        e = warp_photometric(src.to(dev), tgt.to(dev), tx, ty, "affine", 15, 0.85)
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
    and one T a step plus the photometric S, one L, one E each way and two
    P each way a scale (the photometric and the geo grid) and E's identity
    error, and its metrics equal 3 eager
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
                                           "P/fwd": 12, "P/bwd": 12, "L/affine": 6,
                                           "E/fwd/C3": 9, "E/bwd/C3": 6, "A/sumsq": 3,
                                           "A/clip": 3, "A/step": 3}
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
    moments bf16 under the latter, and a second replay that trains on; L
    and E's forward launch once a photometric term, twice under
    photo_remat (its recomputation in the backward), E's forward once more
    for the identity error, E's backward once a term."""
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
    remat = knob == "model.remat"
    assert chunk.captured_launches == {"S/grad/C3": 4, "S/grad/C1": 2, "T/C1": 2,
                                       "P/fwd": 8, "P/bwd": 8, "L/affine": 8 if remat else 4,
                                       "E/fwd/C3": 10 if remat else 6, "E/bwd/C3": 4,
                                       "A/sumsq": 2, "A/clip": 2, "A/step": 2}
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
    and L (its ``global+affine`` LCC's windowed step, once an iteration and
    twice a batch after them) and E (its error, likewise, with a backward
    an iteration), its Adam through A (one A/step an iteration) against
    the same call with the sampler's plain version,
    captured anew: poses to 1e-4."""
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
                      "S/value/C1": 6, "L/affine": 3 * iters + 6, "E/fwd/C3": 3 * iters + 6,
                      "E/bwd/C3": 3 * iters, "A/step": 3 * iters}, counts
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
def test_three_deterministic_captured_steps_with_the_bf16_moment_equal_three_eager_ones(device):
    """As the test above with ``train.adam_mu_dtype="bfloat16"``: 3 replays
    of the captured step give the metrics, weights and bf16 Adam moments
    of 3 eager ``train_step`` calls, bit for bit (A/step rounds μ to bf16
    inside the graph as in the eager steps, whose gradients move)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = _DET_CHILD.replace("cfg.model.n_scales = 2\n",
                               "cfg.model.n_scales = 2\ncfg.train.adam_mu_dtype = 'bfloat16'\n")
    assert "bfloat16" in child
    out = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True,
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
    at a replay after the weights changed in place; of our kernels only L
    and E launched, L once a source a call (its warp is the plain sampler)
    and E twice (its error and its identity error)."""
    import types

    from colvo_torch.pipelines import make_training_eval_hook
    from colvo_torch.runtime import graphs

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
    # the warm-up, the hook's and the test's two calls of the program each,
    # and the two eager bodies
    calls = graphs.WARMUP + 2 * 2 + 2
    n = len(cfg.data.frame_offsets) * calls
    assert kernels.launch_counts() == {"L/affine": n, "E/fwd/C3": 2 * n}
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
    and the geo grid of each scale, 8 L/affine, 10 E/fwd/C3 and 8
    E/bwd/C3) × (3 replays + the warm-up), none in
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
                                           "P/fwd": 8 * n, "P/bwd": 8 * n, "L/affine": 8 * n,
                                           "E/fwd/C3": 10 * n, "E/bwd/C3": 8 * n,
                                           "A/sumsq": n, "A/clip": n, "A/step": n}
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


# loss knobs of the snippet-loss test, P's launches each way a step
# (grids: the photometric one of each scale; a geo grid of its own unless
# the geo term reuses it; under "sym" the reverse warps' grid besides) and
# E's (one forward and backward a photometric term, once for the batched
# stack, the forward twice under photo_remat; a forward for each identity
# error, at each scale under photo_native)
LOSS_KNOBS = {
    "default": ({}, 8, (10, 8)),
    "geo_grad=sym": ({"geo_grad": "sym"}, 12, (10, 8)),
    "photo_native": ({"photo_native": True}, 4, (16, 8)),
    "geo_full_res": ({"geo_full_res": True}, 4, (10, 8)),
    "photo_remat": ({"photo_remat": True}, 8, (18, 8)),
    "batched_photo": ({"batched_photo": True}, 8, (3, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("knob", list(LOSS_KNOBS))
def test_snippet_loss_with_p_matches_the_cpu_plain_path(device, knob):
    """``snippet_loss`` at 64×96, B = 2, four scales, two sources, on one
    set of disparities and poses from a float32 model: on the card (P, S
    and T) the loss terms within 1e-4 relative and the gradients of the
    disparities and poses within 1e-3 of their norm of the CPU's plain
    path (S's and T's sums, and near-tie min-reprojection choices, differ
    in their last bits), with P launched as the knob's grids give it and
    E as its photometric terms and identity errors do."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.losses import snippet_loss
    from colvo_torch.runtime import init_state, to_device

    knobs, launches, (e_fwd, e_bwd) = LOSS_KNOBS[knob]
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
            assert (counts["E/fwd/C3"], counts["E/bwd/C3"]) == (e_fwd, e_bwd), counts
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
    photometric and the geo grid of each scale), beside its S, T, 8 L (one
    a photometric term) and E: 10 forwards (the 8 terms and the 2 identity
    errors) and 8 backwards; the
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
                                       "T/C1": 1, "L/affine": 8, "E/fwd/C3": 10, "E/bwd/C3": 8,
                                       "A/sumsq": 1, "A/clip": 1, "A/step": 1}
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


def _lcc_frames(n, h, w, device, seed=0):
    """A warp (n, h, w, 3) as the loss hands it, a permuted plane stack, with
    smooth structure and noise, and an interleaved target that relights it
    by a gain and an offset varying across the frame."""
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h), torch.linspace(0, 1, w), indexing="ij")
    base = 0.5 + 0.3 * torch.sin(6 * xx + 4 * yy)[None, :, :, None] + 0.2 * torch.rand(
        (n, h, w, 3), generator=gen)
    tgt = ((0.7 + 0.5 * xx[None, :, :, None]) * base + 0.1 * yy[None, :, :, None]
           + 0.02 * torch.rand((n, h, w, 3), generator=gen)).clamp(0, 1.5)
    warp = base.permute(0, 3, 1, 2).contiguous().to(device).permute(0, 2, 3, 1)
    return warp, tgt.contiguous().to(device)


def _lcc_plain(warp, target, mode, dtype):
    """ŵ and a (= ∂ŵ/∂w) of the plain path in ``dtype``."""
    from colvo_torch.kernels import lcc

    x = warp.to(dtype).requires_grad_()
    out = lcc.window_plain(x, target.to(dtype), 15, (0.5, 2.0), mode)
    (a,) = torch.autograd.grad(out, x, torch.ones_like(out))
    return out.detach(), a


def _gap(got, want):
    return (got.double() - want.double()).abs().max().item()


# The floor of L's comparison with the float64 plain path: ŵ, a (the CPU
# test's, tests/test_torch_port_lcc_emu.py).
LCC_FLOOR = (2e-6, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 320), (224, 280)], ids=["train_device", "train_dpt"])
@pytest.mark.parametrize("mode", ["affine", "gain"])
def test_lcc_kernel_matches_the_plain_path_at_the_cells_shapes(device, hw, mode):
    """L at the training cells' shapes (B = 12): ŵ and a no farther from the
    float64 plain path than twice the float32 plain path's distance plus
    ``LCC_FLOOR``; ŵ in the warp's layout; one launch."""
    from colvo_torch.kernels import lcc

    warp, target = _lcc_frames(12, *hw, device)
    kernels.reset_launch_counts()
    out, a = lcc.forward(warp, target, 15, (0.5, 2.0), mode, True)
    assert kernels.launch_counts() == {f"L/{mode}": 1}
    assert out.stride() == a.stride() == warp.stride()
    want64 = _lcc_plain(warp, target, mode, torch.float64)
    want32 = _lcc_plain(warp, target, mode, torch.float32)
    for got, w64, w32, floor in zip((out, a), want64, want32, LCC_FLOOR):
        assert torch.isfinite(got).all()
        assert _gap(got, w64) <= 2 * _gap(w32, w64) + floor, (_gap(got, w64), _gap(w32, w64))


@pytest.mark.cuda
def test_lcc_kernel_in_bfloat16(device):
    """bfloat16 frames (``loss.compute_dtype``): ŵ and a stored in bfloat16,
    within one bfloat16 unit in the last place (2^-7 of the value) of the
    float32 plain path on the same inputs: the kernel's float32 value and
    the plain path's may round to neighbouring bfloat16 values."""
    from colvo_torch.kernels import lcc

    warp, target = (x.to(torch.bfloat16) for x in _lcc_frames(12, 256, 320, device))
    out, a = lcc.forward(warp, target, 15, (0.5, 2.0), "affine", True)
    assert out.dtype == a.dtype == torch.bfloat16
    for got, ref in zip((out, a), _lcc_plain(warp, target, "affine", torch.float32)):
        assert ((got.float() - ref).abs() <= 2.0**-7 * ref.abs() + 1e-5).all()


def _ssim_plain(warp, target, g, dtype):
    """e and the warp's cotangent of the plain path in ``dtype``."""
    from colvo_torch.kernels import ssim
    from colvo_torch.kernels.window import photometric_error

    warp, target, g = warp.to(dtype), target.to(dtype), g.to(dtype)
    return (photometric_error(warp, target, 0.85), ssim.backward_plain(warp, target, g, 0.85))


# The floor of E's comparison with the float64 plain path, of the largest
# magnitude: e, the warp's cotangent (the CPU test's,
# tests/test_torch_port_ssim_emu.py).
SSIM_FLOOR = (1e-6, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 320), (224, 280)], ids=["train_device", "train_dpt"])
def test_ssim_kernel_matches_the_plain_path_at_the_cells_shapes(device, hw):
    """E at the training cells' shapes (B = 12, L's inputs: a permuted plane
    stack against an interleaved target), float32: e and the warp's
    cotangent no farther from the float64 plain path than twice the
    float32 plain path's distance plus ``SSIM_FLOOR``; the cotangent in the
    warp's layout; one launch each way."""
    from colvo_torch.kernels import ssim

    warp, target = _lcc_frames(12, *hw, device)
    g = torch.randn(warp.shape[:-1], device=device)
    kernels.reset_launch_counts()
    got = ssim.forward(warp, target, 0.85), ssim.backward(warp, target, g, 0.85)
    assert kernels.launch_counts() == {"E/fwd/C3": 1, "E/bwd/C3": 1}
    assert got[1].stride() == warp.stride()
    want64, want32 = _ssim_plain(warp, target, g, torch.float64), _ssim_plain(warp, target, g,
                                                                              torch.float32)
    for x, w64, w32, floor in zip(got, want64, want32, SSIM_FLOOR):
        assert torch.isfinite(x).all()
        bound = 2 * _gap(w32, w64) + floor * w64.abs().max().item()
        assert _gap(x, w64) <= bound, (_gap(x, w64), _gap(w32, w64))


@pytest.mark.cuda
def test_ssim_kernel_in_bfloat16(device):
    """bfloat16 frames (``loss.compute_dtype``): e and the warp's cotangent
    stored in bfloat16, no farther from the float64 plain path on the same
    inputs than twice the float32 plain path's distance plus one bfloat16
    unit in the last place (2^-7 of the value): E's float32 arithmetic,
    then one rounding."""
    from colvo_torch.kernels import ssim

    warp, target = (x.to(torch.bfloat16) for x in _lcc_frames(12, 256, 320, device))
    g = torch.randn(warp.shape[:-1], device=device).to(torch.bfloat16)
    got = ssim.forward(warp, target, 0.85), ssim.backward(warp, target, g, 0.85)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for x, w64, w32 in zip(got, _ssim_plain(warp, target, g, torch.float64),
                           _ssim_plain(warp, target, g, torch.float32)):
        assert ((x.double() - w64).abs() <= 2 * _gap(w32, w64) + 2.0**-7 * w64.abs()).all()


@pytest.mark.cuda
def test_ssim_gradient_through_the_wrapper_and_the_bits_repeat(device):
    """Through ``kernels.ssim_error``: the warp's gradient is E's backward
    bit for bit; two calls give the same bits; a target that requires a
    gradient raises and launches nothing; in the batched
    stack (6-D, the target broadcast over sources and scales) a warp that
    broadcasts over the scales gets its gradient summed back to its shape,
    as the plain path's, and each image of the stack is held to the plain
    path as the cells' shapes are."""
    from colvo_torch.kernels import ssim
    from colvo_torch.kernels.window import photometric_error

    warp, target = _lcc_frames(12, 256, 320, device)
    x = warp.clone().requires_grad_()
    e = kernels.ssim_error(x, target)
    g = torch.randn_like(e)
    (dx,) = torch.autograd.grad(e, x, g)
    assert torch.equal(e.detach(), ssim.forward(warp, target, 0.85))
    assert torch.equal(dx, ssim.backward(warp, target, g, 0.85))
    assert torch.equal(dx, ssim.backward(warp, target, g, 0.85))
    t = target.clone().requires_grad_()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        kernels.ssim_error(warp, t)
    with pytest.raises(ValueError):
        kernels.ssim_error(x, t)
    assert kernels.launch_counts() == {}
    stack = _lcc_frames(2 * 3 * 2, 64, 96, device)[0].reshape(2, 3, 2, 64, 96, 3)
    tgt = _lcc_frames(3, 64, 96, device, seed=1)[1][None, :, None]
    xs = stack[:1, :, :1].clone().requires_grad_()
    tgt2 = tgt.expand(1, 3, 2, 64, 96, 3)
    es = kernels.ssim_error(xs, tgt2)
    gs = torch.randn_like(es)
    (dxs,) = torch.autograd.grad(es, xs, gs)
    assert es.shape == (1, 3, 2, 64, 96) and dxs.shape == xs.shape
    assert torch.equal(dxs, ssim.backward(xs.detach(), tgt2, gs, 0.85))
    w64, w32 = (ssim.backward_plain(xs.detach().to(dt), tgt2.to(dt), gs.to(dt), 0.85)
                for dt in (torch.float64, torch.float32))
    assert _gap(dxs, w64) <= 2 * _gap(w32, w64) + SSIM_FLOOR[1] * w64.abs().max().item()
    e2 = kernels.ssim_error(stack, tgt)
    want64, want32 = (torch.cat([photometric_error(stack[i, j, k][None].to(dtype),
                                                   tgt[0, j, 0][None].to(dtype), 0.85)
                                 for i in range(2) for j in range(3) for k in range(2)])
                      for dtype in (torch.float64, torch.float32))
    gap = _gap(e2.reshape(-1, 64, 96), want64)
    assert gap <= 2 * _gap(want32, want64) + SSIM_FLOOR[0] * want64.abs().max().item(), gap


@pytest.mark.cuda
def test_ssim_kernel_captures_in_a_cuda_graph(device):
    """E captured in a CUDA graph, forward and backward: a replay on new
    inputs copied into the static ones equals eager calls bit for bit."""
    from colvo_torch.kernels import ssim

    warp, target = _lcc_frames(12, 256, 320, device)
    new_w, new_t = _lcc_frames(12, 256, 320, device, seed=5)
    g = torch.randn(warp.shape[:-1], device=device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssim.forward(warp, target, 0.85), ssim.backward(warp, target, g, 0.85)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        e, d = ssim.forward(warp, target, 0.85), ssim.backward(warp, target, g, 0.85)
    warp.copy_(new_w)
    target.copy_(new_t)
    graph.replay()
    assert torch.equal(e, ssim.forward(new_w, new_t, 0.85))
    assert torch.equal(d, ssim.backward(new_w, new_t, g, 0.85))


@pytest.mark.cuda
def test_ssim_wrapper_rejects_what_it_cannot_launch(device):
    """float16, mixed dtypes or devices, CPU tensors and channels whose
    tiles cannot fit shared memory raise; nothing falls back."""
    from colvo_torch.kernels import ssim

    warp, target = _lcc_frames(2, 32, 48, device)
    wide = torch.rand(1, 16, 16, 64, device=device)
    for bad, exc in (((warp.half(), target.half()), TypeError),
                     ((warp, target.double()), TypeError),
                     ((warp, target.cpu()), ValueError),
                     ((warp.cpu(), target.cpu()), ValueError),
                     ((wide, wide), ValueError)):
        with pytest.raises(exc):
            ssim.forward(*bad, 0.85)


# The card's bfloat16 loss against the CPU's. L computes LCC's windowed
# means in float32 and stores ŵ in bfloat16, and E computes SSIM's means
# and the error in float32 and stores e in bfloat16; the CPU's plain path
# (the JAX package's arithmetic) rounds each mean to bfloat16 before var
# and cov cancel. On these inputs each arithmetic puts its bf16 loss up to
# 3.1e-3 from the float32 loss, and the two lie up to 1.6e-3 apart in the
# loss and its terms, at a pose-gradient cosine of 0.9928 or more
# (measured on the CPU with L's arithmetic in its plain form: seeds 0-3, 5
# and 9, the three knobs; with E's too, 1.3e-3 and 0.9933 at seeds 0-3).
# The limits leave room for that and for the card's other kernels: 5e-3
# relative on the loss and each term, and a cosine above 0.98 (the
# reference's own bf16 bound is 0.97).
BF16_LOSS_REL, BF16_POSE_COS = 5e-3, 0.98


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{}, {"lcc_mode": "global+affine"}, {"batched_photo": True}],
                         ids=["affine", "global_affine", "batched_photo"])
def test_bf16_loss_on_the_card_stays_near_the_cpus(device, knobs):
    """``loss.compute_dtype="bfloat16"``: ``snippet_loss`` on one 64×96
    snippet of uniform noise (four scales, two sources) on the card, where
    L computes in float32, and on the CPU, where the windowed means round
    to bfloat16: the loss and its terms within ``BF16_LOSS_REL`` of the
    CPU's and the pose gradients at a cosine above ``BF16_POSE_COS``, and
    the card launches L and E for every term."""
    from colvo_torch.losses import snippet_loss

    h, w = 64, 96
    rng = np.random.default_rng(1)
    frames = rng.random((1, 3, h, w, 3)).astype(np.float32)
    k = np.array([[0.58 * w, 0, w / 2], [0, 0.92 * h, h / 2], [0, 0, 1]], np.float32)
    disps = [{s: (0.05 + 0.9 * rng.random((1, h >> s, w >> s, 1))).astype(np.float32)
              for s in range(4)} for _ in range(3)]
    poses = (0.01 * rng.standard_normal((1, 2, 6))).astype(np.float32)
    cfg = ColvoConfig()
    cfg.loss.compute_dtype = "bfloat16"
    for key, v in knobs.items():
        setattr(cfg.loss, key, v)
    results = {}
    for dev in (device, torch.device("cpu")):
        ds = [{s: torch.tensor(v, device=dev, requires_grad=True) for s, v in d.items()}
              for d in disps]
        ps = torch.tensor(poses, device=dev, requires_grad=True)
        kk = torch.tensor(k, device=dev)
        kernels.reset_launch_counts()
        loss, aux = snippet_loss(ds, ps, torch.tensor(frames, device=dev), kk,
                                 torch.linalg.inv(kk), cfg.loss, cfg.model)
        loss.backward()
        if dev.type == "cuda":
            counts = kernels.launch_counts()
            terms = 1 if knobs.get("batched_photo") else 8
            assert counts.get("L/affine") == terms, counts
            assert (counts.get("E/fwd/C3"), counts.get("E/bwd/C3")) == (terms + 2, terms), counts
        terms = {key: v.item() for key, v in aux.items() if v.dim() == 0}
        results[dev.type] = loss.item(), terms, ps.grad.flatten().cpu().double()
    (got_l, got_t, got_g), (want_l, want_t, want_g) = results["cuda"], results["cpu"]
    assert abs(got_l - want_l) <= BF16_LOSS_REL * abs(want_l), (got_l, want_l)
    for key, v in want_t.items():
        assert abs(got_t[key] - v) <= BF16_LOSS_REL * max(abs(v), 1e-6), (key, got_t[key], v)
    cos = (got_g @ want_g / (got_g.norm() * want_g.norm())).item()
    assert cos > BF16_POSE_COS, cos


@pytest.mark.cuda
def test_lcc_gradient_is_g_times_a_and_the_bits_repeat(device):
    """Through ``kernels.lcc_window``: the warp's gradient is g·a bit for
    bit, the target gets none; two calls give ŵ and a bit for bit, and so
    do calls on 6 of the 12 images and on one (other row splits); a
    target broadcast over sources and scales (the batched stack) sums the
    gradient back to a warp that broadcast too, and each image of the
    stack is held to the plain path as the cells' shapes are."""
    from colvo_torch.kernels import lcc

    warp, target = _lcc_frames(12, 256, 320, device)
    x = warp.clone().requires_grad_()
    t = target.clone().requires_grad_()
    y = kernels.lcc_window(x, t, 15, (0.5, 2.0), "affine")
    g = torch.randn_like(y)
    dx, dt = torch.autograd.grad(y, (x, t), g, allow_unused=True)
    first = lcc.forward(warp, target, 15, (0.5, 2.0), "affine", True)
    again = lcc.forward(warp, target, 15, (0.5, 2.0), "affine", True)
    half = lcc.forward(warp[:6], target[:6], 15, (0.5, 2.0), "affine", True)
    one = lcc.forward(warp[7:8], target[7:8], 15, (0.5, 2.0), "affine", True)
    assert dt is None
    assert torch.equal(y.detach(), first[0]) and torch.equal(dx, g * first[1])
    assert all(torch.equal(p, q) for p, q in zip(first, again))
    assert all(torch.equal(p[:6], q) for p, q in zip(first, half))
    assert all(torch.equal(p[7:8], q) for p, q in zip(first, one))
    stack = _lcc_frames(2 * 3 * 2, 64, 96, device)[0].reshape(2, 3, 2, 64, 96, 3)
    tgt = _lcc_frames(3, 64, 96, device, seed=1)[1][None, :, None]
    xs = stack[:1].clone().requires_grad_()  # broadcast over the sources too
    ys = kernels.lcc_window(xs, tgt, 15)
    gs = torch.randn_like(ys)
    (dxs,) = torch.autograd.grad(ys, xs, gs)
    _, a = lcc.forward(xs.detach(), tgt, 15, (0.5, 2.0), "affine", True)
    assert ys.shape == (1, 3, 2, 64, 96, 3) and torch.equal(dxs, gs * a)
    y2 = kernels.lcc_window(stack, tgt, 15)
    assert ys.shape[1:] == y2.shape[1:]
    want64, want32 = (torch.cat([_lcc_plain(stack[i, j, k][None], tgt[0, j, 0][None], "affine",
                                            dtype)[0] for i in range(2) for j in range(3)
                                 for k in range(2)])
                      for dtype in (torch.float64, torch.float32))
    gap = _gap(y2.reshape(-1, 64, 96, 3), want64)
    assert gap <= 2 * _gap(want32, want64) + LCC_FLOOR[0], (gap, _gap(want32, want64))


@pytest.mark.cuda
def test_lcc_kernel_captures_in_a_cuda_graph(device):
    """L captured in a CUDA graph: a replay on new inputs copied into the
    static ones equals an eager call bit for bit."""
    from colvo_torch.kernels import lcc

    warp, target = _lcc_frames(12, 256, 320, device)
    new_w, new_t = _lcc_frames(12, 256, 320, device, seed=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lcc.forward(warp, target, 15, (0.5, 2.0), "affine", True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, a = lcc.forward(warp, target, 15, (0.5, 2.0), "affine", True)
    warp.copy_(new_w)
    target.copy_(new_t)
    graph.replay()
    want = lcc.forward(new_w, new_t, 15, (0.5, 2.0), "affine", True)
    assert torch.equal(out, want[0]) and torch.equal(a, want[1])


@pytest.mark.cuda
def test_lcc_wrapper_rejects_what_it_cannot_launch(device):
    """float16, mixed dtypes or devices, CPU tensors, an unknown mode and a
    window that cannot fit shared memory raise; nothing falls back."""
    from colvo_torch.kernels import lcc

    warp, target = _lcc_frames(2, 32, 48, device)
    for bad, exc in (((warp.half(), target.half(), 15, "affine"), TypeError),
                     ((warp, target.double(), 15, "affine"), TypeError),
                     ((warp, target.cpu(), 15, "affine"), ValueError),
                     ((warp.cpu(), target.cpu(), 15, "affine"), ValueError),
                     ((warp, target, 15, "global"), ValueError),
                     ((warp, target, 301, "affine"), ValueError)):
        with pytest.raises(exc):
            lcc.forward(*bad[:3], (0.5, 2.0), bad[3], True)


# (loss knobs, size, L and E launches of one loss with its backward: E's
# forward once a photometric term that F does not compute and once for the
# automask's identity error of each source, its backward once a term)
LCC_LOSSES = {
    "default": ({}, (64, 96), {"L/affine": 8, "E/fwd/C3": 8 + 2, "E/bwd/C3": 8}),
    "fused_kernel": ({"fused_kernel": True}, (64, 96), {"E/fwd/C3": 0 + 2}),
    "batched_photo": ({"batched_photo": True}, (64, 96),
                      {"L/affine": 1, "E/fwd/C3": 1 + 2, "E/bwd/C3": 1}),
    "lcc_mode=gain": ({"lcc_mode": "gain"}, (64, 96),
                      {"L/gain": 8, "E/fwd/C3": 8 + 2, "E/bwd/C3": 8}),
    # _dpt_setup's net: one scale
    "dpt": ({}, (56, 70), {"L/affine": 2, "E/fwd/C3": 2 + 2, "E/bwd/C3": 2}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("knob", list(LCC_LOSSES))
def test_lcc_launches_of_one_loss(device, knob, monkeypatch):
    """``snippet_loss`` with its backward, two sources: L and E once a
    photometric term (8 at four scales, 2 at the DPT net's one scale),
    once for the batched stack, none under ``loss.fused_kernel`` (F
    computes the error itself), and E's forward for each identity error;
    no ``avg_pool2d`` kernel is left in the loss, forward or backward: L
    computes LCC's windows and E SSIM's."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.losses import snippet_loss
    from colvo_torch.runtime import init_state, to_device

    loss_knobs, (h, w), want = LCC_LOSSES[knob]
    if knob == "dpt":
        cfg, batches = _dpt_setup(device, monkeypatch)
        batch = batches[0]
    else:
        cfg = ColvoConfig()
        cfg.model.dtype = "float32"
        cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 2
        for key, v in loss_knobs.items():
            setattr(cfg.loss, key, v)
        seq = render_sequence(n_frames=8, height=h, width=w, seed=4)
        batch = to_device(next(batch_iterator(
            SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data, seed=0)),
            device)
    state = init_state(cfg, seed=0, device=device)
    disps, poses = state.model(batch["frames"])
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss, _ = snippet_loss(disps, poses, batch["frames"], batch["k"],
                               torch.linalg.inv(batch["k"]), cfg.loss, cfg.model,
                               frames_clean=batch["frames_clean"])
        loss.backward()
        torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launch_counts().items() if k[0] in "LE"} == want
    assert torch.isfinite(loss)
    pools = [e for e in prof.key_averages() if "avg_pool2d" in e.key]
    assert not pools, [(e.key, e.count) for e in pools]


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


# MPViT-Small's four stages at 256×320 over a default step's 36 frames:
# (tokens, width); 8 heads, so d = 8, 16, 27 and 36.
FA_STAGES = [(5120, 64), (1280, 128), (320, 216), (80, 288)]


def _fa_inputs(device, n, c, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(36, n, 3 * c, generator=gen, device=device)
    qkv[..., c:2 * c] *= 3.0  # a peaked softmax over the tokens
    cv, g = (torch.randn(36, n, c, generator=gen, device=device) for _ in range(2))
    return qkv.bfloat16(), cv.bfloat16(), g.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", FA_STAGES, ids=[f"n{n}-c{c}" for n, c in FA_STAGES])
def test_fa_matches_float64_at_the_stage_shapes(device, n, c):
    """FA's forward and backward on bfloat16 inputs against the plain op and
    its autograd gradient in float64 on the same inputs: each output part
    (out; dq, dk and dv of ∂qkv each; dcv) within 2·2⁻⁸ of its own largest
    magnitude (the bfloat16 store's rounding, 2⁻⁹ of an element, twice over
    for the float32 sums of up to 5,120 terms before it); and the same bits
    on a second call."""
    from colvo_torch.kernels.factor_attention import factor_attention_plain

    fa = kernels.factor_attention
    qkv, cv, g = _fa_inputs(device, n, c, seed=n + c)
    outs = []
    for _ in range(2):
        a, b = qkv.clone().requires_grad_(True), cv.clone().requires_grad_(True)
        out = fa(a, b, 8)
        da, db = torch.autograd.grad(out, (a, b), g)
        outs.append((out.detach(), da, db))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    a, b = qkv.double().requires_grad_(True), cv.double().requires_grad_(True)
    ref = factor_attention_plain(a, b, 8)
    want = (ref.detach(), *torch.autograd.grad(ref, (a, b), g.double()))
    for x, y in zip(outs[0], want):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape

    def parts(out, dqkv, dcv):
        return (out, *dqkv.unflatten(-1, (3, c)).unbind(-2), dcv)

    for name, x, y in zip(("out", "dq", "dk", "dv", "dcv"), parts(*outs[0]), parts(*want)):
        gap = (x.double() - y).abs().max().item()
        assert gap <= 2 * 2.0 ** -8 * y.abs().max().item(), (name, gap)


@pytest.mark.cuda
def test_fa_launches_of_a_default_mpvit_step_and_captured_batchnorm(device):
    """A step of ``colvo_mpvit_s`` (four scales, DCDP, bf16, 256×320, B = 2)
    launches FA 38 times forward and 38 backward, one a path-layer (2·1 +
    3·3 + 3·6 + 3·3). The captured step from the same weights gives the
    eager step's loss terms bit for bit and leaves BatchNorm's running
    statistics where the eager step does (its warm-up's update is put
    back), bit for bit, each count 1."""
    from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
    from colvo_torch.runtime import init_state, make_train_step, to_device, train_step

    cfg = ColvoConfig()
    cfg.model.depth_net = "mpvit_s"
    cfg.data.batch_size = 2
    seq = render_sequence(n_frames=6, height=256, width=320, seed=3)
    it = batch_iterator(SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets), cfg.data,
                        seed=0)
    batch = to_device(next(it), device)
    eager, graphed = (init_state(cfg, seed=0, device=device) for _ in range(2))
    kernels.reset_launch_counts()
    want = train_step(eager, batch, cfg)
    counts = kernels.launch_counts()
    assert counts.get("FA/fwd") == 38 and counts.get("FA/bwd") == 38, counts
    got = make_train_step(graphed, cfg)(graphed, batch)
    for key in ("loss/total", "loss/photometric", "loss/smoothness", "loss/geometric"):
        assert torch.equal(got[key], want[key]), key
    bufs = dict(graphed.model.named_buffers())
    for name, b in eager.model.named_buffers():
        assert torch.equal(bufs[name], b), name
        if name.endswith("num_batches_tracked"):
            assert int(b) == 1


# Kernel A's list: sizes as MPViT's list mixes them (1-element tensors, odd
# lengths, a quad exactly), and tensors of many chunks.
ADAM_SIZES = (1, 3, 4, 5, 7, 8, 33, 1, 1000, 4097, 2, 70001, 64, 1, 9, 1 << 20, 3 * 4096 + 3)


def _adam_list(sizes, seed, device, offsets=(0,), scale=1.0):
    """Tensors of ``sizes`` with normal values on ``device``, the i-th a view
    ``offsets[i % len(offsets)]`` elements into its own buffer (misaligned
    where that is not a multiple of 4)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        off = offsets[i % len(offsets)]
        out.append((scale * torch.randn(n + off, generator=gen)).to(device)[off:])
    return out


def _adam_models():
    """The training models' parameter shapes (the benchmark's configs)."""
    import json

    from colvo_torch.models import ColVOModel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for name in ("colvo_r18_gn", "colvo_mpvit_s", "colvo_dav2_vitl"):
        cfg = ColvoConfig()
        with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
            overrides = json.load(f)["overrides"]
        cfg.apply_overrides([f"{k}={json.dumps(v)}" for k, v in overrides.items()])
        with torch.device("meta"):
            out[name] = [tuple(p.shape) for p in ColVOModel(cfg.model).parameters()]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_step_kernel_equals_the_plain_chain_bit_for_bit(device, mu_dtype, weight_decay):
    """Three A/steps against ``adam.step_plain`` (the foreach chain) on the
    card, on copies: p, μ, ν and every step count bit for bit after steps 1
    and 3, on a list that mixes sizes, some tensors misaligned (views 1-3
    elements into their buffers: A's element-wise path), the learning rate
    a device tensor; one A/step launch a step."""
    from colvo_torch.kernels import adam

    ps = _adam_list(ADAM_SIZES, 1, device, offsets=(0, 1, 0, 2, 0, 3))
    ref = [p.clone() for p in ps]
    ms, rm = ([torch.zeros_like(p, dtype=mu_dtype) for p in ps] for _ in range(2))
    vs, rv = ([torch.zeros_like(p) for p in ps] for _ in range(2))
    steps, rs = ([torch.zeros((), device=device) for _ in ps] for _ in range(2))
    lr = torch.tensor(2e-3, device=device)
    plans = adam.Plans()
    kernels.reset_launch_counts()
    for k in range(3):
        gs = _adam_list(ADAM_SIZES, 10 + k, device, offsets=(0, 0, 0, 1))
        adam.adam_update(ps, gs, ms, vs, steps, lr, (0.9, 0.999), 1e-8, weight_decay,
                         plans=plans)
        adam.step_plain(ref, gs, rm, rv, rs, lr, (0.9, 0.999), 1e-8, weight_decay)
        if k in (0, 2):
            for got, want in ((ps, ref), (ms, rm), (vs, rv), (steps, rs)):
                for i, (x, y) in enumerate(zip(got, want)):
                    assert x.dtype == y.dtype and torch.equal(x, y), (k, i, x.numel())
    assert kernels.launch_counts() == {"A/step": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["colvo_r18_gn", "colvo_mpvit_s", "colvo_dav2_vitl"])
def test_adam_kernels_at_the_training_models_lists(device, name):
    """At a training model's parameter list (160, 742 and 470 tensors): the
    norm within 1e-6 of float64's, the clip engaged equal to g times the
    written scale, and an AdamW step with a bf16 μ from a step count of 2
    bit for bit the foreach chain's."""
    from colvo_torch.kernels import adam

    shapes = _adam_models()[name]
    gen = torch.Generator(device=device).manual_seed(5)
    gs = [torch.randn(s, device=device, generator=gen) * 1e-3 for s in shapes]
    want = torch.sqrt(sum((g.double() ** 2).sum() for g in gs))
    g0 = [g.clone() for g in gs]
    norm = adam.clip_global_norm(gs, 0.5 * float(want))
    assert abs(float(norm) - float(want)) <= 1e-6 * float(want)
    scale = torch.reciprocal(norm) * (0.5 * float(want))
    assert all(torch.equal(g, x * scale) for g, x in zip(gs, g0))
    del g0
    ps = [torch.randn(s, device=device, generator=gen) for s in shapes]
    ms = [(torch.randn(s, device=device, generator=gen) * 1e-3).bfloat16() for s in shapes]
    vs = [torch.rand(s, device=device, generator=gen) * 1e-6 for s in shapes]
    steps = [torch.full((), 2.0, device=device) for _ in shapes]
    ref = [[x.clone() for x in xs] for xs in (ps, ms, vs, steps)]
    args = (torch.tensor(1e-4, device=device), (0.9, 0.999), 1e-8, 1e-2)
    adam.adam_update(ps, gs, ms, vs, steps, *args, plans=adam.Plans())
    adam.step_plain(ref[0], gs, ref[1], ref[2], ref[3], *args)
    for got, want in zip((ps, ms, vs, steps), ref):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_adam_norm_is_the_same_bits_in_every_replay_and_scale_one_writes_nothing(device):
    """A/sumsq and A/clip captured in a CUDA graph and replayed twice, and
    called eagerly: the norm is the same bits each time, within 1e-6 of
    float64's; the limit above it, the scale is 1 and the gradients keep
    their bits (signed zeros and subnormals too)."""
    from colvo_torch.kernels import adam

    gs = _adam_list(ADAM_SIZES, 4, device, offsets=(0, 3, 0, 1, 2), scale=1e-3)
    gs[0][0], gs[3][2], gs[6][5] = -0.0, 1e-45, -3e-39
    before = [g.clone() for g in gs]
    want = float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))
    eager = adam.clip_global_norm(gs, 1e6).clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adam.clip_global_norm(gs, 1e6)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = adam.clip_global_norm(gs, 1e6)
    norms = []
    for _ in range(2):
        graph.replay()
        norms.append(out.clone())
    for norm in norms:
        assert torch.equal(norm.view(torch.int32), eager.view(torch.int32))
    assert abs(float(eager) - want) <= 1e-6 * want
    for g, b in zip(gs, before):
        assert torch.equal(g.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_adam_wrappers_reject_what_they_cannot_launch(device):
    """On the card: float64 parameters, a μ of float16, step counts on the
    host and a learning rate on the host are refused; nothing falls back
    to the chain."""
    from colvo_torch.kernels import adam

    p = [torch.zeros(8, device=device)]
    mus, nus = [torch.zeros(8, device=device)], [torch.zeros(8, device=device)]
    steps = [torch.zeros((), device=device)]
    args, kw = ((0.9, 0.999), 1e-8, 0.0), {"plans": adam.Plans()}
    with pytest.raises(TypeError, match="params"):
        adam.adam_update([p[0].double()], [p[0].double()], mus, nus, steps, 1e-3, *args, **kw)
    with pytest.raises(TypeError, match="mus"):
        adam.adam_update(p, p, [mus[0].half()], nus, steps, 1e-3, *args, **kw)
    with pytest.raises(ValueError, match="step counts"):
        adam.adam_update(p, p, mus, nus, [torch.zeros(())], 1e-3, *args, **kw)
    with pytest.raises(ValueError, match="learning rate"):
        adam.adam_update(p, p, mus, nus, steps, torch.tensor(1e-3), *args, **kw)
    with pytest.raises(TypeError, match="grads"):
        adam.clip_global_norm([p[0].double()], 1.0)


@pytest.mark.cuda
def test_adam_keeps_its_step_counts_on_the_card_whatever_capturable_says(device):
    """``Adam`` with its default ``capturable=False`` and a float learning
    rate trains on the card, its step counts on the card, bit for bit as a
    capturable one with the rate a device tensor; a state dict whose counts
    lie on the host (as a checkpoint of a non-capturable optimizer holds
    them) loads, and the next step moves them to the card and equals the
    capturable one's."""
    from colvo_torch.runtime.optim import Adam

    gen = torch.Generator().manual_seed(3)
    p0 = [torch.randn(s, generator=gen) for s in ((5,), (3, 7), (1,))]
    grads = [[torch.randn(p.shape, generator=gen).to(device) for p in p0] for _ in range(3)]
    a = [p.to(device).requires_grad_(True) for p in p0]
    b = [p.to(device).requires_grad_(True) for p in p0]
    opt_a = Adam(a, lr=1e-3)
    opt_b = Adam(b, lr=torch.tensor(1e-3, device=device), capturable=True)
    for step in range(2):
        for ps, opt in ((a, opt_a), (b, opt_b)):
            for p, g in zip(ps, grads[step]):
                p.grad = g.clone()
            opt.step()
    assert all(opt_a.state[p]["step"].device == a[0].device for p in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sd = opt_a.state_dict()
    for st in sd["state"].values():
        st["step"] = st["step"].cpu()
    c = [p.detach().clone().requires_grad_(True) for p in a]
    opt_c = Adam(c, lr=1e-3)
    opt_c.load_state_dict(sd)
    for ps, opt in ((c, opt_c), (b, opt_b)):
        for p, g in zip(ps, grads[2]):
            p.grad = g.clone()
        opt.step()
    assert all(opt_c.state[p]["step"].device == c[0].device for p in c)
    assert all(torch.equal(x, y) for x, y in zip(c, b))
    for p, q in zip(c, b):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt_c.state[p][key], opt_b.state[q][key])


@pytest.mark.cuda
def test_capture_survives_a_graph_dropped_in_a_reference_cycle(device):
    """A CUDA graph dropped inside a reference cycle is destroyed by the
    cyclic garbage collector, and destroying it is not permitted while
    another stream captures. ``Graphed`` collects no cycles inside its
    capture: a body that drops such a cycle during the capture, then
    allocates enough to trigger collections, still captures, and its
    replays compute the body."""
    import gc

    from colvo_torch.runtime import graphs

    x = torch.ones(8, device=device)
    old = torch.cuda.CUDAGraph()
    with torch.cuda.graph(old):
        x * 3
    box = [old]
    del old

    def body(a):
        if torch.cuda.is_current_stream_capturing() and box:
            cycle = [box.pop()]
            cycle.append(cycle)
            del cycle
            junk = [[i] for i in range(5 * max(gc.get_threshold()[0], 1))]
            del junk
        return a * 2 + 1

    prog = graphs.Graphed(body, device=device)
    gc.collect()
    assert torch.equal(prog(x), x * 2 + 1)
    assert not box
    assert torch.equal(prog(x + 1), (x + 1) * 2 + 1)
    gc.collect()
    torch.cuda.synchronize()


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
