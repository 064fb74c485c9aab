"""Kernels S and T's CUDA sources (``csrc/sampler.cu``, ``csrc/scatter.cu``)
on the CPU.

Both sources are compiled with the host's C++ compiler against the CUDA
shim of ``test_torch_port_fused_emu.py`` (a ``std::thread`` per CUDA
thread, barriers for ``__syncthreads`` and the warp reductions, atomic
references for ``atomicAdd``). The descriptor tables come from the
wrappers' own ``multi_params``, so this runs the Python side of a launch
and the kernels' indexing (descriptor lookup, the four-pixel float4 path
and the scalar path of S; T's warp tiles and the joining of terms of one
cell across lanes and rows)
against the plain versions, at the card's tolerances (``chip_smoke.py``):
S value 1e-5 and d/dx, d/dy 1e-4 abs, T 1e-4 of max|d_src|. T's
deterministic variant (fixed-point int64 atomics, ``train.deterministic``)
is held there too, and against itself compiled with ``-DSHIM_REVERSE``
(every pass's blocks and threads run in reverse order): the same bits.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from colvo_torch.kernels import build, sampler, scatter
from test_torch_port_fused_emu import SHIM

LAUNCH = re.compile(r"([\w]+(?:<\w+>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*[^>]+>>>\(")


def _compile(d, cxx, name, *flags):
    src = (build.CSRC / f"{name}.cu").read_text()
    src = src.replace("extern __shared__ float smem[];", "float* smem = block_smem;")
    src, n_launch = LAUNCH.subn(r"shim_launch(\1, \2, \3, \4, ", src)
    assert n_launch >= 1
    (d / f"{name}.cpp").write_text(src)
    out = d / f"{name}{''.join(flags)}.so"
    run = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w", *flags,
                          f"-I{d}", f"-I{build.CSRC}", "-o", str(out), str(d / f"{name}.cpp")],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return ctypes.CDLL(str(out))


def _scatter_fns(lib):
    lib.colvo_bilinear_scatter_multi.argtypes = [scatter.ScatterParams, ctypes.c_void_p,
                                                 ctypes.c_longlong, ctypes.c_void_p]
    lib.colvo_bilinear_scatter_multi_det.argtypes = [scatter.ScatterParams, ctypes.c_void_p,
                                                     ctypes.c_longlong, ctypes.c_void_p,
                                                     ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler")
    d = tmp_path_factory.mktemp("geo_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    s_lib, t_lib = _compile(d, cxx, "sampler"), _scatter_fns(_compile(d, cxx, "scatter"))
    s_lib.colvo_bilinear_sample_multi.argtypes = [sampler.GeoParams, ctypes.c_void_p]
    # the same scatter source, its blocks and threads run in reverse order
    t_rev = _scatter_fns(_compile(d, cxx, "scatter", "-DSHIM_REVERSE"))
    return s_lib, t_lib, t_rev


def _coords(n, h, w, hs, ws, seed, kind):
    """smooth: a zoom, shift and wobble onto an (hs, ws) source, with a
    band out of bounds; wild: uniform over and beyond the source; huge:
    smooth with ±1e20 and 3e9 coords (taps that clamp and wrap); shift: a
    constant subpixel shift, where every term joins its neighbours';
    border: past the right edge, where all taps of a pixel are one cell,
    and columns whose lower x tap stays while the upper one moves."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if kind == "wild":
        x = rng.uniform(-3, ws + 3, (n, h, w))
        y = rng.uniform(-3, hs + 3, (n, h, w))
    elif kind == "shift":
        x = np.broadcast_to(gx + 0.3, (n, h, w)).copy()
        y = np.broadcast_to(gy + 0.6, (n, h, w)).copy()
    elif kind == "border":
        x = ws + rng.uniform(0, 5, (n, h, w))
        y = gy[None] * (hs / h) + rng.uniform(0, hs, (n, 1, w)) * (gx[None] > w // 2)
        # the left quarter: a lower tap of column 0 in every row, the upper
        # one of column 0 and 1 by turns
        x[:, :, : w // 4] = np.where(gy[:, : w // 4] % 2 == 0, -0.5, 0.5)
        y[:, :, : w // 4] = gy[:, : w // 4] + 0.5
    else:
        x = gx[None] * (ws / w) * rng.uniform(0.9, 1.1, (n, 1, 1)) + rng.normal(0, 0.7, (n, h, w))
        y = gy[None] * (hs / h) + rng.uniform(-2, 2, (n, 1, 1)) + rng.normal(0, 0.7, (n, h, w))
        x[:, :, :2] = rng.uniform(-20, ws + 20, (n, h, 2))
        if kind == "huge":
            x[0, 1, 3], x[0, 2, 5], x[-1, -1, -2] = 1e20, -1e20, 3e9
            y[0, 3, 1], y[-1, 2, 4], y[0, -1, 0] = 1e20, -1e20, 3e9
    return (torch.tensor(x.astype(np.float32)), torch.tensor(y.astype(np.float32)))


# (n, c, h, w, hs, ws, kind): sources (n, c, hs, ws) sampled onto (n, h, w)
SETS = [
    (3, 1, 16, 24, 18, 26, "smooth"),    # w % 4 == 0: four pixels a thread
    (2, 1, 11, 17, 13, 15, "huge"),      # odd width: a pixel a thread
    (2, 1, 40, 80, 100, 120, "wild"),    # nothing joins
    (1, 1, 8, 12, 300, 260, "huge"),     # a larger source than output
    (2, 1, 19, 64, 21, 70, "shift"),     # every term joins; rows past a warp tile
    (1, 1, 12, 40, 10, 30, "border"),    # the taps of a pixel on one cell
]


def _inputs(sets, seed):
    rng = np.random.default_rng(seed)
    srcs, xs, ys, gs = [], [], [], []
    for i, (n, c, h, w, hs, ws, kind) in enumerate(sets):
        # a source one frame longer than used: a batch stride of its own
        srcs.append(torch.tensor(rng.random((n + 1, c, hs, ws), dtype=np.float32))[1:])
        x, y = _coords(n, h, w, hs, ws, seed + i, kind)
        xs.append(x)
        ys.append(y)
        g = torch.tensor(rng.normal(size=(n, c, h, w)).astype(np.float32))
        g[:, :, : h // 4] = 0.0  # zero-cotangent rows
        gs.append(g)
    return srcs, xs, ys, gs


@pytest.mark.parametrize("with_grad", [True, False])
def test_sampler_source_matches_plain_version(libs, with_grad):
    """Several descriptors in one launch, on both paths of the kernel; a
    coordinate plane one float off a 16-byte boundary takes the scalar
    path at a width that is a multiple of 4."""
    srcs, xs, ys, _ = _inputs(SETS, 3)
    shifted = torch.empty(xs[0].numel() + 1)[1:].view_as(xs[0])
    shifted.copy_(xs[0])
    xs.append(shifted)
    ys.append(ys[0])
    srcs.append(srcs[0])
    params, outs = sampler.multi_params(srcs, xs, ys, with_grad)
    assert [params.d[i].vec for i in range(len(srcs))] == [1, 0, 1, 1, 1, 1, 0]
    for o in outs:
        for t in o:
            if t is not None:
                t.fill_(float("nan"))
    assert libs[0].colvo_bilinear_sample_multi(params, None) == 0
    for got, src, x, y in zip(outs, srcs, xs, ys):
        want = sampler.sample_plain(src, x, y, with_grad)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        for k, p in zip(got[1:], want[1:]):
            if with_grad:
                torch.testing.assert_close(k, p, atol=1e-4, rtol=0)
            else:
                assert k is None and p is None


@pytest.mark.parametrize("sets", [SETS, [(2, 2, 20, 36, 22, 30, "smooth")]],
                         ids=["four_sets", "two_channels"])
def test_scatter_source_matches_plain_version(libs, sets):
    """Warps where terms of one cell join across lanes and rows, where
    none do, and where all four taps of a pixel are one cell; wrapped
    taps, zero-cotangent rows, an odd width and partial warp tiles, in one
    launch over a buffer the entry point zeroes."""
    _, xs, ys, gs = _inputs(sets, 5)
    hws = [(hs, ws) for _, _, _, _, hs, ws, _ in sets]
    params, buf, outs = scatter.multi_params(xs, ys, gs, hws)
    buf.fill_(float("nan"))
    assert libs[1].colvo_bilinear_scatter_multi(params, buf.data_ptr(), buf.numel(), None) == 0
    for got, x, y, g, hw in zip(outs, xs, ys, gs, hws):
        want = scatter.scatter_plain(x, y, g, *hw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)


def _det_scatter(lib, xs, ys, gs, hws):
    params, buf, outs = scatter.multi_params(xs, ys, gs, hws)
    buf.fill_(float("nan"))
    ws = scatter.det_workspace(params, buf)
    ws.fill_(-1)  # the entry point zeroes it
    assert lib.colvo_bilinear_scatter_multi_det(params, buf.data_ptr(), buf.numel(),
                                                ws.data_ptr(), None) == 0
    return outs


@pytest.mark.parametrize("sets", [SETS, [(2, 2, 20, 36, 22, 30, "smooth")]],
                         ids=["four_sets", "two_channels"])
def test_deterministic_scatter_matches_plain_version_in_any_order(libs, sets):
    """The fixed-point variant (train.deterministic) on the smooth, huge,
    wild (out of bounds), shift and border warps, in one launch: within T's
    tolerance of the plain version, and bit for bit the same when the
    shim runs the blocks and threads of every pass in reverse order."""
    _, xs, ys, gs = _inputs(sets, 5)
    hws = [(hs, ws) for _, _, _, _, hs, ws, _ in sets]
    fwd = _det_scatter(libs[1], xs, ys, gs, hws)
    rev = _det_scatter(libs[2], xs, ys, gs, hws)
    for got, back, x, y, g, hw in zip(fwd, rev, xs, ys, gs, hws):
        want = scatter.scatter_plain(x, y, g, *hw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)
        assert torch.equal(got.view(torch.int32), back.view(torch.int32))


def test_deterministic_scatter_nan_and_zero_planes(libs):
    """A plane with a NaN or inf cotangent, or a NaN coordinate, comes out
    NaN in every cell; a plane with a zero cotangent comes out zero; the
    other planes of the launch are untouched by either."""
    sets = [(4, 1, 16, 24, 18, 26, "smooth"), (2, 1, 8, 12, 10, 14, "wild")]
    _, xs, ys, gs = _inputs(sets, 7)
    gs[0][0, 0, 5, 5] = float("nan")
    gs[0][1, 0, 6, 7] = float("inf")
    gs[0][2] = 0.0
    xs[1][1, 3, 4] = float("nan")
    hws = [(hs, ws) for _, _, _, _, hs, ws, _ in sets]
    got = _det_scatter(libs[1], xs, ys, gs, hws)
    assert torch.isnan(got[0][:2]).all() and torch.isnan(got[1][1]).all()
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    for out, x, y, g, hw, plane in ((got[0], xs[0], ys[0], gs[0], hws[0], 3),
                                    (got[1], xs[1], ys[1], gs[1], hws[1], 0)):
        want = scatter.scatter_plain(x[plane:plane + 1], y[plane:plane + 1],
                                     g[plane:plane + 1], *hw)
        torch.testing.assert_close(out[plane:plane + 1], want,
                                   atol=1e-4 * want.abs().max().item(), rtol=0)
