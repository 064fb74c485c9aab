"""Kernel L's CUDA source (``csrc/lcc.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py`` (a ``std::thread`` per CUDA thread, barriers for
``__syncthreads``, plain copies for ``cp.async``; the shim reports 4 SMs,
so a frame splits into several row ranges), with its bfloat16 header
(``BF16``), and fed by the wrapper's own ``lcc.args``.
That runs the kernel's strip walk (the
strips and their halo, the row ranges, the ring of rows, the vertical
walkers' restarts and their kept sums, the horizontal segments, the
staging tile and the stores in the output's stride-1 order) against the
plain ``lcc_calibrate`` in float64 and float32 on the same inputs: ŵ and
a may be no farther from the float64 plain path than twice what the
float32 plain path is, plus a floor (``FLOOR``) for where the float32
plain path happens to come out exact. Built with ``-DSHIM_REVERSE`` (the
blocks of a grid and the threads of a block run last to first) the
output is the same bits: no sum depends on the order in which the CTAs
run, nor on the other images of the call.
"""

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.kernels import build, lcc
from colvo_torch.losses.photometric import lcc_calibrate
from cuda_emu import BF16, CP_ASYNC, SHIM, compile_source, workdir

# The floor of the comparison with the float64 plain path: ŵ, a.
FLOOR = (2e-6, 2e-5)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """L as built for the card, and with the blocks and threads reversed."""
    d, cxx = workdir(tmp_path_factory, "lcc_emu", {"cuda_runtime.h": SHIM, "cuda_bf16.h": BF16,
                                                   "cp_async.cuh": CP_ASYNC})
    return tuple(lcc.bind(compile_source(d, cxx, "lcc", *flags))
                 for flags in ((), ("-DSHIM_REVERSE",)))


def _frames(lead, h, w, c, seed, layout="nhwc", target_lead=None):
    """A warp (*lead, h, w, c) in [0, 1] with smooth structure and noise,
    and a target that relights it by a gain and an offset varying across
    the frame, plus noise; ``layout`` "planes" gives the warp the loss's
    permuted plane stack (strides (c·h·w, w, 1, h·w) over the flattened
    lead). ``target_lead`` (dims of size 1 broadcasting) takes the target
    from the first warp along those dims."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    n = int(np.prod(lead)) if lead else 1
    base = (0.5 + 0.3 * np.sin(6 * xx + 4 * yy)[None, :, :, None]
            + 0.2 * rng.random((n, h, w, c)))
    gain = 0.7 + 0.5 * xx[None, :, :, None]
    tgt = np.clip(gain * base + 0.1 * yy[None, :, :, None] + 0.02 * rng.random((n, h, w, c)),
                  0, 1.5)
    warp = torch.tensor(base, dtype=torch.float32)
    if layout == "planes":
        warp = warp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    warp = warp.reshape(*lead, h, w, c)
    target = torch.tensor(tgt, dtype=torch.float32).reshape(*lead, h, w, c)
    if target_lead is not None:
        target = target[tuple(slice(0, 1) if s == 1 else slice(None) for s in target_lead)]
    return warp, target


def _run(lib, warped, target, window, mode, clip=(0.5, 2.0)):
    """ŵ and a through ``lib``'s entry point, into buffers of NaN in the
    layout the wrapper gives them."""
    shape = torch.broadcast_shapes(warped.shape, target.shape)
    out, a = build.like(warped, shape).fill_(float("nan")), build.like(warped, shape)
    a.fill_(float("nan"))
    p = lcc.args(warped, target, out, a, window, clip, mode)
    bf16 = int(warped.dtype == torch.bfloat16)
    assert lib.colvo_lcc_window(p, shape[:-3].numel(), bf16, None) == 0
    return out, a


def _plain(warped, target, window, mode, dtype):
    """ŵ and a of the plain path in ``dtype`` (a = ∂ŵ/∂w of the windowed
    step, by autograd); ``global+affine`` takes the global step first."""
    warped, target = warped.to(dtype), target.to(dtype)
    if mode.startswith("global"):
        warped, mode = lcc_calibrate(warped, target, "global"), mode[len("global+"):]
    w = warped.requires_grad_()
    out = lcc.window_plain(w, target, window, (0.5, 2.0), mode)
    (a,) = torch.autograd.grad(out, w, torch.ones_like(out))
    return out.detach(), a


def _gap(got, want):
    return (got.double() - want.double()).abs().max().item()


# (lead, h, w, c, window, mode, layout, target_lead)
CASES = [
    ((2,), 37, 53, 3, 15, "affine", "planes", None),      # the main window; H, W cut a strip
    ((1,), 150, 70, 3, 14, "affine", "nhwc", None),       # even window; many chunks, two strips
    ((2,), 20, 25, 3, 31, "gain", "nhwc", None),          # a window larger than the image
    ((2,), 9, 7, 3, 3, "affine", "planes", None),         # a direct window; smaller than a chunk
    ((1,), 150, 70, 3, 3, "affine", "nhwc", None),       # a direct window over chunks, two strips
    ((2, 2, 2), 33, 41, 3, 15, "affine", "planes", (1, 2, 1)),  # the stack, target broadcast
    ((2,), 70, 131, 3, 15, "gain", "planes", None),       # gain over three strips
    ((1,), 41, 30, 8, 15, "affine", "nhwc", None),        # 8 channels: walkers restart every chunk
    ((2,), 33, 41, 3, 15, "global+affine", "planes", None),  # the plain global step, then L
]


@pytest.mark.parametrize("lead,h,w,c,window,mode,layout,target_lead", CASES,
                         ids=[f"{c[5]}-L{c[4]}-{'x'.join(map(str, c[0]))}x{c[1]}x{c[2]}x{c[3]}"
                              f"-{c[6]}" for c in CASES])
def test_lcc_source_matches_plain_path(libs, lead, h, w, c, window, mode, layout, target_lead):
    """ŵ and a no farther from the float64 plain path than twice the float32
    plain path's distance plus ``FLOOR``; every element written; ŵ in the
    warp's layout. Under ``global+affine`` L takes the plain global step's
    output, and ŵ is held to the plain ``lcc_calibrate`` of the whole
    mode too."""
    torch.set_num_threads(2)
    warped, target = _frames(lead, h, w, c, 11 + window, layout, target_lead)
    if mode == "global+affine":
        glob = lcc_calibrate(warped, target, "global")
        out, a = _run(libs[0], glob, target, window, "affine")
        want64 = lcc_calibrate(warped.double(), target.double(), mode, window)
        want32 = lcc_calibrate(warped, target, mode, window)
        assert _gap(out, want64) <= 2 * _gap(want32, want64) + FLOOR[0]
    else:
        out, a = _run(libs[0], warped, target, window, mode)
    assert torch.isfinite(out).all() and torch.isfinite(a).all()
    assert out.stride() == warped.stride()
    want64 = _plain(warped, target, window, mode, torch.float64)
    want32 = _plain(warped, target, window, mode, torch.float32)
    for got, w64, w32, floor in zip((out, a), want64, want32, FLOOR):
        assert _gap(got, w64) <= 2 * _gap(w32, w64) + floor, (_gap(got, w64), _gap(w32, w64))


@pytest.mark.parametrize("layout", ["planes", "nhwc"])
def test_lcc_source_in_bfloat16(libs, layout):
    """bfloat16 storage, float32 arithmetic: ŵ and a within one bfloat16
    unit in the last place (2^-7 of the value) of the float32 plain path on
    the same (bfloat16) inputs: the kernel's float32 value and the plain
    path's may round to neighbouring bfloat16 values."""
    warped, target = _frames((2,), 37, 53, 3, 3, layout)
    wb, tb = warped.to(torch.bfloat16), target.to(torch.bfloat16)
    out, a = _run(libs[0], wb, tb, 15, "affine")
    assert out.dtype == a.dtype == torch.bfloat16
    want = _plain(wb, tb, 15, "affine", torch.float32)
    for got, ref in zip((out, a), want):
        assert ((got.float() - ref).abs() <= 2.0**-7 * ref.abs() + 1e-5).all()


@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[6]], ids=["main", "batched", "c8"])
def test_lcc_source_gives_the_same_bits_in_any_block_order(libs, case):
    """The build that runs a grid's blocks and a block's threads last to
    first gives ŵ and a bit for bit, and so does a second call."""
    lead, h, w, c, window, mode, layout, target_lead = case
    warped, target = _frames(lead, h, w, c, 2, layout, target_lead)
    first = _run(libs[0], warped, target, window, mode)
    again = _run(libs[0], warped, target, window, mode)
    rev = _run(libs[1], warped, target, window, mode)
    for x, y, z in zip(first, again, rev):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        assert torch.equal(x.view(torch.int32), z.view(torch.int32))


@pytest.mark.parametrize("window", [15, 14, 3])
def test_lcc_source_gives_an_image_the_same_bits_in_any_batch(libs, window):
    """An image's ŵ and a are the same bits in a call of four images and
    alone, though the host splits its rows into other ranges (the shim's
    8 CTA slots: two ranges of 48 rows, or five of 16): the running sums
    restart on the same rows either way."""
    warped, target = _frames((4,), 70, 53, 3, 9, "planes")
    together = _run(libs[0], warped, target, window, "affine")
    for i in range(4):
        alone = _run(libs[0], warped[i:i + 1], target[i:i + 1], window, "affine")
        for x, y in zip(together, alone):
            assert torch.equal(x[i:i + 1].contiguous().view(torch.int32),
                               y.contiguous().view(torch.int32)), i


def test_lcc_source_refuses_a_window_that_cannot_fit(libs):
    """A window whose strip cannot fit shared memory at the narrowest strip
    is refused at launch, not run."""
    warped, target = _frames((1,), 20, 20, 3, 1)
    out, a = build.like(warped, warped.shape), build.like(warped, warped.shape)
    p = lcc.args(warped, target, out, a, 301, (0.5, 2.0), "affine")
    assert libs[0].colvo_lcc_window(p, 1, 0, None) != 0


def test_lcc_window_on_the_cpu_is_the_plain_path():
    """``kernels.lcc_window`` and ``lcc_calibrate`` on CPU tensors are the
    plain means bit for bit, with the gradient g·a to the warp alone."""
    warped, target = _frames((2,), 17, 19, 3, 4, "planes")
    w = warped.clone().requires_grad_()
    got = kernels.lcc_window(w, target, 15, (0.5, 2.0), "affine")
    assert torch.equal(got, lcc_calibrate(warped, target, "affine", 15))
    want, a = _plain(warped, target, 15, "affine", torch.float32)
    assert torch.equal(got.detach(), want)
    g = torch.randn(got.shape)
    (dw,) = torch.autograd.grad(got, w, g)
    assert torch.equal(dw, g * a)
    with pytest.raises(ValueError):
        lcc_calibrate(warped, target, "bogus", 15)
