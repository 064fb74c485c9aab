"""Kernel E's CUDA source (``csrc/ssim.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py`` (a ``std::thread`` per CUDA thread, barriers for
``__syncthreads``, plain copies for ``cp.async``), with its bfloat16 header
(``BF16``), and fed by the wrapper's own ``ssim.args``. That runs the
kernels' tiles (their halos at the image's edges and at the tiles' seams,
the loads in either stride-1 order, the images' offsets over broadcast
leading dims, the ring of the windows' backward terms and the stores in
the output's stride-1 order) against the plain
``window.photometric_error`` in float64 and float32 on the same inputs, forward and, by autograd, backward: e and
the warp's cotangent may be no farther from the float64 plain path than
twice what the float32 plain path is, plus a floor (``FLOOR``, relative
to the largest magnitude) for where the float32 plain path happens to come
out exact. Built with ``-DSHIM_REVERSE`` (the blocks of a grid and the
threads of a block run last to first) the outputs are the same bits.
"""

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.kernels import build, ssim
from colvo_torch.kernels.window import photometric_error
from cuda_emu import BF16, CP_ASYNC, SHIM, compile_source, workdir

ALPHA = 0.85
# The floor of the comparison with the float64 plain path, relative to the
# largest magnitude of the float64 output: e, the warp's cotangent.
FLOOR = (1e-6, 1e-5)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """E as built for the card, and with the blocks and threads reversed."""
    d, cxx = workdir(tmp_path_factory, "ssim_emu", {"cuda_runtime.h": SHIM, "cuda_bf16.h": BF16,
                                                    "cp_async.cuh": CP_ASYNC})
    return tuple(ssim.bind(compile_source(d, cxx, "ssim", *flags))
                 for flags in ((), ("-DSHIM_REVERSE",)))


def _frames(lead, h, w, c, seed, layout="nhwc", target_lead=None, tie=False):
    """A warp (*lead, h, w, c) in [0, 1] with smooth structure and noise, and
    a target that relights it by a gain and an offset varying across the
    frame, plus noise; ``layout`` "planes" gives the warp the loss's
    permuted plane stack. ``target_lead`` (dims of size 1 broadcasting)
    takes the target from the first warp along those dims. ``tie`` makes
    the target equal the warp on the left half of every frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    n = int(np.prod(lead)) if lead else 1
    base = (0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[None, :, :, None]
            + 0.2 * rng.random((n, h, w, c)))
    tgt = np.clip((0.7 + 0.5 * xx[None, :, :, None]) * base + 0.1 * yy[None, :, :, None]
                  + 0.02 * rng.random((n, h, w, c)), 0, 1.5)
    if tie:
        tgt[:, :, : w // 2] = base[:, :, : w // 2]
    warp = torch.tensor(base, dtype=torch.float32)
    if layout == "planes":
        warp = warp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    warp = warp.reshape(*lead, h, w, c)
    target = torch.tensor(tgt, dtype=torch.float32).reshape(*lead, h, w, c)
    if target_lead is not None:
        target = target[tuple(slice(0, 1) if s == 1 else slice(None) for s in target_lead)]
    g = torch.tensor(rng.standard_normal((n, h, w)), dtype=torch.float32).reshape(*lead, h, w)
    return warp, target, g


def _fwd(lib, pred, target):
    """e through ``lib``'s forward, into a buffer of NaN."""
    shape = torch.broadcast_shapes(pred.shape, target.shape)
    e = torch.full(shape[:-1], float("nan"), dtype=pred.dtype)
    p = ssim.args(pred, target, e, None, ALPHA)
    assert lib.colvo_ssim_err_fwd(p, shape[:-3].numel(), int(pred.dtype == torch.bfloat16),
                                 None) == 0
    return e


def _bwd(lib, pred, target, g):
    """The warp's cotangent through ``lib``'s backward, into a buffer of NaN
    in the layout the wrapper gives it."""
    shape = torch.broadcast_shapes(pred.shape, target.shape)
    d = build.like(pred, shape).fill_(float("nan"))
    p = ssim.args(pred, target, d, g, ALPHA)
    assert lib.colvo_ssim_err_bwd(p, shape[:-3].numel(), int(pred.dtype == torch.bfloat16),
                                 None) == 0
    return d


def _plain(pred, target, g, dtype):
    """e and the warp's cotangent of the plain path in ``dtype``."""
    pred, target, g = pred.to(dtype), target.to(dtype), g.to(dtype)
    return (photometric_error(pred, target, ALPHA),
            ssim.backward_plain(pred, target, g, ALPHA))


def _gap(got, want):
    return (got.double() - want.double()).abs().max().item()


# (lead, h, w, c, layout, target_lead, tie)
CASES = [
    ((2,), 37, 53, 3, "planes", None, False),          # tiles cut by H and W; the loss's layouts
    ((1,), 1, 1, 3, "nhwc", None, False),              # one pixel
    ((2,), 3, 5, 3, "nhwc", None, False),              # smaller than a tile
    ((2,), 20, 33, 1, "nhwc", None, False),            # one channel
    ((3,), 19, 70, 1, "planes", None, False),          # one channel over three tile columns
    ((2, 2, 2), 18, 35, 3, "planes", (1, 2, 1), False),  # batched_photo's stack, target broadcast
    ((2,), 17, 40, 3, "nhwc", None, True),             # ŵ = t on half the frame
]
IDS = [f"{'x'.join(map(str, c[0]))}x{c[1]}x{c[2]}x{c[3]}-{c[4]}"
       + ("-bcast" if c[5] else "") + ("-tie" if c[6] else "") for c in CASES]


@pytest.mark.parametrize("lead,h,w,c,layout,target_lead,tie", CASES, ids=IDS)
def test_ssim_source_matches_plain_path(libs, lead, h, w, c, layout, target_lead, tie):
    """e and the warp's cotangent no farther from the float64 plain path
    than twice the float32 plain path's distance plus ``FLOOR``; every
    element written; the cotangent in the warp's layout."""
    torch.set_num_threads(2)
    warped, target, g = _frames(lead, h, w, c, 7 + h, layout, target_lead, tie)
    got = (_fwd(libs[0], warped, target), _bwd(libs[0], warped, target, g))
    assert all(torch.isfinite(x).all() for x in got)
    assert got[1].stride() == warped.stride()
    want64, want32 = _plain(warped, target, g, torch.float64), _plain(warped, target, g,
                                                                       torch.float32)
    for x, w64, w32, floor in zip(got, want64, want32, FLOOR):
        bound = 2 * _gap(w32, w64) + floor * w64.abs().max().item()
        assert _gap(x, w64) <= bound, (_gap(x, w64), _gap(w32, w64))
    if tie:  # the tied half's L1 subgradient is 0 on both paths: the SSIM term's alone
        ssim_only = ssim.backward_plain(warped.double(), target.double(), g.double(), 1.0) * ALPHA
        half = (slice(None), slice(None), slice(1, w // 2 - 1))
        assert _gap(got[1][half], ssim_only[half]) <= 2 * _gap(want32[1], want64[1]) + (
            FLOOR[1] * want64[1].abs().max().item())


@pytest.mark.parametrize("layout", ["planes", "nhwc"])
def test_ssim_source_in_bfloat16(libs, layout):
    """bfloat16 storage, float32 arithmetic: on the same (bfloat16) inputs,
    e and the warp's cotangent no farther from the float64 plain path than
    twice the float32 plain path's distance plus one bfloat16 unit in the
    last place (2^-7 of the value), the rounding of the float32 value."""
    warped, target, g = _frames((2,), 37, 53, 3, 3, layout)
    wb, tb, gb = (x.to(torch.bfloat16) for x in (warped, target, g))
    got = (_fwd(libs[0], wb, tb), _bwd(libs[0], wb, tb, gb))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for x, w64, w32 in zip(got, _plain(wb, tb, gb, torch.float64),
                           _plain(wb, tb, gb, torch.float32)):
        tol = 2 * _gap(w32, w64) + 2.0**-7 * w64.abs()
        assert ((x.double() - w64).abs() <= tol).all()


@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=["main", "stack"])
def test_ssim_source_gives_the_same_bits_in_any_block_order(libs, case):
    """The build that runs a grid's blocks and a block's threads last to
    first gives e and the warp's cotangent bit for bit, and so does a
    second call."""
    lead, h, w, c, layout, target_lead, tie = case
    warped, target, g = _frames(lead, h, w, c, 2, layout, target_lead, tie)
    for run in (_fwd, lambda lib, *a: _bwd(lib, *a, g)):
        first, again, rev = (run(lib, warped, target) for lib in (libs[0], libs[0], libs[1]))
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
        assert torch.equal(first.view(torch.int32), rev.view(torch.int32))


def test_ssim_source_refuses_channels_that_cannot_fit(libs):
    """Channels whose tiles cannot fit shared memory are refused at launch,
    not run."""
    warped, target, g = _frames((1,), 8, 8, 64, 1)
    e = torch.empty(warped.shape[:-1])
    assert libs[0].colvo_ssim_err_fwd(ssim.args(warped, target, e, None, ALPHA), 1, 0, None) != 0
    d = torch.empty(warped.shape)
    assert libs[0].colvo_ssim_err_bwd(ssim.args(warped, target, d, g, ALPHA), 1, 0, None) != 0


def test_ssim_error_on_the_cpu_is_the_plain_path():
    """``kernels.ssim_error`` on CPU tensors is ``window.photometric_error``
    bit for bit, with its gradient to the warp and, where it requires one,
    to the target."""
    warped, target, g = _frames((2,), 17, 19, 3, 4, "planes")
    w, t = warped.clone().requires_grad_(), target.clone().requires_grad_()
    got = kernels.ssim_error(w, t, ALPHA)
    want = photometric_error(warped, target, ALPHA)
    assert torch.equal(got.detach(), want)
    dw, dt = torch.autograd.grad(got, (w, t), g)
    assert torch.equal(dw, ssim.backward_plain(warped, target, g, ALPHA))
    x, y = warped.clone().requires_grad_(), target.clone().requires_grad_()
    assert torch.equal(dt, torch.autograd.grad(photometric_error(x, y, ALPHA), y, g)[0])
