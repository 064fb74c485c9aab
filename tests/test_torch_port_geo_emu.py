"""Kernels S and T's CUDA sources (``csrc/sampler.cu``, ``csrc/scatter.cu``)
on the CPU.

Both sources are compiled with the host's C++ compiler against the CUDA
shim of ``test_torch_port_fused_emu.py`` (a ``std::thread`` per CUDA
thread, barriers for ``__syncthreads`` and the warp reductions, atomic
references for ``atomicAdd``, the blocks of a thread-block cluster at
once) and against ``CLUSTER``, this file's version of the port's
``csrc/cluster.cuh`` on that shim. The descriptor tables come from the
wrappers' own ``multi_params``, so this runs the Python side of a launch
and the kernels' indexing (descriptor lookup, the four-pixel float4 path
and the scalar path of S; T's warp tiles and the joining of terms of one
cell across lanes and rows) against the plain versions, at the card's
tolerances (``chip_smoke.py``): S value 1e-5 and d/dx, d/dy 1e-4 abs, T
1e-4 of max|d_src|. T's deterministic variant (``train.deterministic``)
is held bit for bit to ``scatter_multi_plain_fixed``, and so is the same
source compiled with ``-DSHIM_REVERSE`` (clusters, the blocks in each
and their threads run in reverse order). Built with a small band and one
warp tile a warp (``SMALL``), its planes split over 2 to 8 CTAs of a
cluster, whose terms cross to each other's shared memory, and the larger
ones take the device-memory path.
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

# csrc/cluster.cuh on the shim: a shared::cluster address is a byte pointer
# into the target block's buffer.
CLUSTER = r"""
#pragma once
#include <cuda_runtime.h>
using cluster_addr = unsigned char*;
inline unsigned cluster_rank() { return shim_cluster_rank; }
inline void cluster_sync() { shim_cluster_barrier->arrive_and_wait(); }
inline cluster_addr cluster_map(const void* p, unsigned rank) {
  return shim_cluster_smem[rank] + (static_cast<const unsigned char*>(p) - block_smem_bytes);
}
inline unsigned cluster_fetch_add32(cluster_addr a, unsigned v) {
  return std::atomic_ref<unsigned>(*reinterpret_cast<unsigned*>(a)).fetch_add(v);
}
inline unsigned cluster_load(cluster_addr a) {
  return std::atomic_ref<unsigned>(*reinterpret_cast<unsigned*>(a)).load();
}
inline void cluster_store(cluster_addr a, unsigned v) {
  std::atomic_ref<unsigned>(*reinterpret_cast<unsigned*>(a)).store(v);
}
template <typename... Args>
int cluster_launch(void (*kernel)(Args...), unsigned grid, unsigned threads, size_t smem,
                   unsigned cluster, cudaStream_t, Args... args) {
  shim_launch_cluster(kernel, dim3(grid), threads, smem, cluster, args...);
  return 0;
}
template <typename... Args>
int cluster_occupancy(void (*)(Args...), unsigned, size_t, unsigned, int* n) {
  *n = 1;
  return 0;
}
"""

# T's cluster kernel with 1 KiB bands and at most 4 KiB of shared memory a
# CTA: small planes split over several CTAs, and larger ones take the
# global path.
SMALL = ("-DCOLVO_T_BAND_BYTES=1024", "-DCOLVO_T_SMEM_CAP=4096")


def _compile(d, cxx, name, *flags):
    src = (build.CSRC / f"{name}.cu").read_text()
    src = src.replace("extern __shared__ float smem[];", "float* smem = block_smem;")
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = block_smem_bytes;")
    src, n_launch = LAUNCH.subn(r"shim_launch(\1, \2, \3, \4, ", src)
    assert n_launch >= 1
    (d / f"{name}.cpp").write_text(src)
    out = d / f"{name}{''.join(flags)}.so"
    run = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w", *flags,
                          f"-I{d}", f"-I{build.CSRC}", "-o", str(out), str(d / f"{name}.cpp")],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-4000:]
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """S; T as built for the card, forward and reversed; T with ``SMALL``
    sizes, forward and reversed."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler")
    d = tmp_path_factory.mktemp("geo_emu")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cluster.cuh").write_text(CLUSTER)
    s_lib = _compile(d, cxx, "sampler")
    s_lib.colvo_bilinear_sample_multi.argtypes = [sampler.GeoParams, ctypes.c_void_p]
    t_libs = [scatter.bind(_compile(d, cxx, "scatter", *flags))
              for flags in ((), ("-DSHIM_REVERSE",), SMALL, (*SMALL, "-DSHIM_REVERSE"))]
    return (s_lib, *t_libs)


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
    """The deterministic T of ``lib`` over a buffer of NaN, with a
    workspace of -1 where its plan has a global path (the entry point
    zeroes it); returns the outputs and the plan's paths."""
    params, buf, outs = scatter.multi_params(xs, ys, gs, hws)
    buf.fill_(float("nan"))
    plan = scatter.det_plan(lib, params)
    ws = torch.full((plan.ws_longs,), -1, dtype=torch.int64) if plan.ws_longs else None
    assert lib.colvo_bilinear_scatter_multi_det(params, buf.numel(),
                                                ws.data_ptr() if ws is not None else None,
                                                plan.ws_longs, None) == 0
    return outs, plan.paths


def _same_bits(a, b):
    """Equal bit for bit, NaN matching NaN whatever its payload."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan].view(torch.int32),
                                                            b[~nan].view(torch.int32))


def _det_matches_plain_fixed(fwd_lib, rev_lib, sets, seed, want_paths):
    """Both builds' deterministic T, bit for bit ``scatter_plain_fixed`` and
    within T's tolerance of the plain version, in one launch of the plan's
    ``want_paths``."""
    _, xs, ys, gs = _inputs(sets, seed)
    hws = [(hs, ws) for _, _, _, _, hs, ws, _ in sets]
    fwd, paths = _det_scatter(fwd_lib, xs, ys, gs, hws)
    rev, rev_paths = _det_scatter(rev_lib, xs, ys, gs, hws)
    assert paths == rev_paths == want_paths
    for got, back, x, y, g, hw in zip(fwd, rev, xs, ys, gs, hws):
        fixed = scatter.scatter_plain_fixed(x, y, g, *hw)
        assert _same_bits(got, fixed) and _same_bits(back, fixed)
        want = scatter.scatter_plain(x, y, g, *hw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("sets", [SETS, [(2, 2, 20, 36, 22, 30, "smooth")]],
                         ids=["four_sets", "two_channels"])
def test_deterministic_scatter_matches_plain_version_in_any_order(libs, sets):
    """The fixed-point variant (train.deterministic) on the smooth, huge,
    wild (out of bounds), shift and border warps, in one launch of the
    cluster kernel (planes of 1, 2 and 8 CTAs at these sizes): bit for bit
    ``scatter_plain_fixed``, also when the shim runs the clusters, their
    blocks and threads in reverse order, and within T's tolerance of the
    plain version."""
    _det_matches_plain_fixed(libs[1], libs[2], sets, 5, 1)


# (n, c, h, w, hs, ws, kind) under SMALL
SPLIT_SETS = [
    (3, 1, 16, 24, 18, 26, "smooth"),    # 8 CTAs a plane, bands of 3 rows
    (2, 1, 11, 17, 13, 15, "huge"),      # 2 CTAs; taps that clamp and wrap
    (2, 1, 40, 80, 30, 40, "wild"),      # 8 CTAs; every tap anywhere
    (1, 1, 8, 12, 60, 40, "huge"),       # 8 CTAs of 8 rows; most of the plane gets nothing
    (2, 1, 19, 64, 21, 70, "shift"),     # 8 CTAs, bands of 3 rows
]
GLOBAL_SET = (1, 1, 24, 40, 100, 120, "wild")  # bands of 12.2 KiB at 8 CTAs: over the cap


@pytest.mark.parametrize("sets,paths", [(SPLIT_SETS, 1), (SPLIT_SETS[:3] + [GLOBAL_SET], 3)],
                         ids=["cluster", "cluster_and_global"])
def test_deterministic_scatter_splits_planes_across_a_cluster(libs, sets, paths):
    """Built with ``SMALL``: a plane's terms go to the bands of 2 to 8 CTAs
    of its cluster through their shared memory, and the plane maxima come
    from each other's; a plane set whose bands would not fit takes the
    global path in the same call. Bit for bit ``scatter_plain_fixed``,
    forward and reversed."""
    _det_matches_plain_fixed(libs[3], libs[4], sets, 9, paths)


def test_deterministic_scatter_global_path_as_built(libs):
    """As built for the card: a 500×480 source plane (1.9 MB of sums) does
    not fit 8 CTAs' shared memory and takes the global path, beside a
    plane set of the cluster kernel in the same call; bit for bit
    ``scatter_plain_fixed``, forward and reversed."""
    _det_matches_plain_fixed(libs[1], libs[2], [(2, 1, 12, 40, 500, 480, "wild"), SETS[0]],
                             11, 3)


def _nan_and_zero_planes(lib):
    sets = [(4, 1, 16, 24, 18, 26, "smooth"), (2, 1, 8, 12, 10, 14, "wild")]
    _, xs, ys, gs = _inputs(sets, 7)
    gs[0][0, 0, 5, 5] = float("nan")
    gs[0][1, 0, 6, 7] = float("inf")
    gs[0][2] = 0.0
    xs[1][1, 3, 4] = float("nan")
    hws = [(hs, ws) for _, _, _, _, hs, ws, _ in sets]
    got, _ = _det_scatter(lib, xs, ys, gs, hws)
    assert torch.isnan(got[0][:2]).all() and torch.isnan(got[1][1]).all()
    assert torch.equal(got[0][2], torch.zeros_like(got[0][2]))
    for out, x, y, g, hw in zip(got, xs, ys, gs, hws):
        assert _same_bits(out, scatter.scatter_plain_fixed(x, y, g, *hw))
    for out, x, y, g, hw, plane in ((got[0], xs[0], ys[0], gs[0], hws[0], 3),
                                    (got[1], xs[1], ys[1], gs[1], hws[1], 0)):
        want = scatter.scatter_plain(x[plane:plane + 1], y[plane:plane + 1],
                                     g[plane:plane + 1], *hw)
        torch.testing.assert_close(out[plane:plane + 1], want,
                                   atol=1e-4 * want.abs().max().item(), rtol=0)


def test_deterministic_scatter_nan_and_zero_planes(libs):
    """A plane with a NaN or inf cotangent, or a NaN coordinate, comes out
    NaN in every cell; a plane with a zero cotangent comes out zero; the
    other planes of the launch are untouched by either, bit for bit
    ``scatter_plain_fixed``."""
    _nan_and_zero_planes(libs[1])


def test_deterministic_scatter_nan_reaches_every_cta_of_its_plane(libs):
    """Under ``SMALL`` a plane lies in 8 CTAs of a cluster: the NaN flag of
    a term in one of them makes the plane NaN in all, and the rest as
    above."""
    _nan_and_zero_planes(libs[3])
