"""Kernel P's CUDA source (``csrc/project.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py`` (a ``std::thread`` per CUDA thread,
barriers for ``__syncthreads`` and the warp shuffles), as
``test_torch_port_geo_emu.py`` does for S and T, and its entry points are
fed by the wrapper's own ``project.mats``. That runs the kernels' indexing
(the grids' last partial CTA, a thread's pixels at a stride, the planes
``s·N + n``, K by grid or for all, the transforms' free strides) and the
pose gradient's reduction (a shuffle tree, the walk over the warps, the
partials summed in tile order) against autograd through
``ops.project(ops.backproject(...))`` in float64 on the same float32
inputs: x, y, z within 1e-5 and d_depth, d_T within 1e-4, each relative to
the value and to the largest of its grid. Built with ``-DSHIM_REVERSE``
(the blocks of a grid and the threads of a block run last to first), d_T
and d_depth come out bit for bit the same: no sum depends on the order
in which the CTAs run.
"""

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.kernels import project
from cuda_emu import SHIM, compile_source, workdir


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """P as built for the card, and with the blocks and threads reversed."""
    d, cxx = workdir(tmp_path_factory, "project_emu", {"cuda_runtime.h": SHIM})
    return tuple(project.bind(compile_source(d, cxx, "project", *flags))
                 for flags in ((), ("-DSHIM_REVERSE",)))


def _rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * a + (1 - np.cos(angle)) * a @ a


def _intrinsics(h, w, jitter):
    """A pinhole K for an h×w grid and its inverse with an exact (0, 0, 1)
    bottom row, as float32."""
    f = np.float32(0.9 * w * (1 + jitter))
    cx, cy = np.float32(w / 2 - 0.3), np.float32(h / 2 + 0.2)
    k = np.array([[f, 0, cx], [0, 1.1 * f, cy], [0, 0, 1]], np.float32)
    k_inv = np.array([[1 / f, 0, -cx / f], [0, 1 / (1.1 * f), -cy / (1.1 * f)], [0, 0, 1]],
                     np.float32)
    return k, k_inv


def _inputs(n, s, h, w, k_batched, seed, kind="front"):
    """depth (N, h, w) in [0.5, 5]; K, K⁻¹ (3, 3) or (N, 3, 3); T (S, N, 4,
    4) as the transpose of an (N, S, 4, 4) stack (the loss's layout);
    cotangents (S·N, h, w), zero over a band of rows. ``kind``: "front",
    small motions; "behind", source 1 turned half round, so every pixel
    lands behind its camera; "near_zero", grid 1 at depth 1 + j·2⁻²³ seen
    from z = −1 by an identity rotation, so z is j·2⁻²³ exactly (−2 ≤ j ≤
    2) and the divide's guard decides x and y."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 5.0, (n, h, w)).astype(np.float32)
    ks = [_intrinsics(h, w, 0.05 * i if k_batched else 0.0) for i in range(n)]
    k = np.stack([a for a, _ in ks]) if k_batched else ks[0][0]
    k_inv = np.stack([b for _, b in ks]) if k_batched else ks[0][1]
    t = np.zeros((n, s, 4, 4), np.float32)
    t[..., 3, 3] = 1.0
    for i in range(n):
        for j in range(s):
            t[i, j, :3, :3] = _rotation(rng, rng.uniform(0.01, 0.1))
            t[i, j, :3, 3] = rng.uniform(-0.2, 0.2, 3)
    if kind == "behind":
        t[:, 1, :3, :3] = np.diag([-1.0, 1.0, -1.0]) @ t[:, 1, :3, :3]
        t[:, 1, 2, 3] = -0.2
    if kind == "near_zero":
        depth[1] = 1.0 + rng.integers(-2, 3, (h, w)) * np.float32(2.0**-23)
        t[1, :, :3, :3] = np.eye(3)
        t[1, :, :3, 3] = (0.1, -0.1, -1.0)
    g = rng.normal(size=(3, s * n, h, w)).astype(np.float32)
    g[:, :, : h // 5] = 0.0
    tt = torch.tensor(t).transpose(0, 1)
    return (torch.tensor(depth), torch.tensor(k), torch.tensor(k_inv), tt,
            *torch.tensor(g).unbind(0))


def _run(lib, depth, k, k_inv, t, gx, gy, gz):
    """P's forward and backward through ``lib``'s entry points, into
    buffers of NaN: (x, y, z, d_depth, d_T)."""
    (n, h, w), s = depth.shape, t.shape[0]
    m = project.mats(k, k_inv, t, n)
    x, y, z = torch.full((3, s * n, h, w), float("nan")).unbind(0)
    assert lib.colvo_project_depth_fwd(depth.data_ptr(), m, x.data_ptr(), y.data_ptr(),
                                       z.data_ptr(), n, s, h, w, None) == 0
    d_depth = torch.full_like(depth, float("nan"))
    d_t = torch.full((s, n, 4, 4), float("nan"))
    partial = torch.full((lib.colvo_project_depth_partials(n, s, h, w),), float("nan"))
    assert lib.colvo_project_depth_bwd(depth.data_ptr(), m, gx.data_ptr(), gy.data_ptr(),
                                       gz.data_ptr(), d_depth.data_ptr(), partial.data_ptr(),
                                       d_t.data_ptr(), n, s, h, w, None) == 0
    return x, y, z, d_depth, d_t


def _reference(depth, k, k_inv, t, gx, gy, gz):
    """Autograd through ``project_plain`` (ops.project ∘ ops.backproject) in
    float64 on the same inputs."""
    d = depth.double().requires_grad_()
    tt = t.double().requires_grad_()
    x, y, z = project.project_plain(d, k.double(), k_inv.double(), tt)
    (x * gx.double() + y * gy.double() + z * gz.double()).sum().backward()
    return x.detach(), y.detach(), z.detach(), d.grad, tt.grad


def _close(got, want, rel):
    """got, want (A, N, B) for N grids: |got − want| ≤ rel·(|want| + the
    largest |want| of its grid)."""
    want = want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs() - rel * (want.abs() + want.abs().amax(dim=(0, 2), keepdim=True))
    assert (err <= 0).all(), f"{int((err > 0).sum())} cells off, by up to {err.max().item():.3g}"


# (n, s, h, w, K batched, kind)
CASES = [
    (2, 1, 37, 53, False, "front"),     # 1,961 px: a partial CTA each way, one tile
    (3, 2, 45, 67, True, "front"),      # K by grid; two tiles, the second partial
    (2, 2, 50, 131, False, "front"),    # four tiles
    (2, 2, 23, 29, True, "behind"),     # source 1 behind the camera everywhere
    (2, 2, 31, 41, False, "near_zero"),  # z of grid 1 within 2.4e-7 of 0
]


@pytest.mark.parametrize("n,s,h,w,k_batched,kind", CASES,
                         ids=[f"{c[5]}-{c[0]}x{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_project_source_matches_autograd(libs, n, s, h, w, k_batched, kind):
    """x, y, z within 1e-5 and d_depth, d_T within 1e-4 of autograd through
    the plain path, each relative to the value and to the largest of its
    grid (the near-zero grid's are ~1e9 px and ~1e17)."""
    args = _inputs(n, s, h, w, k_batched, 7 + n + s, kind)
    got = _run(libs[0], *args)
    want = _reference(*args)
    for i in range(3):
        _close(got[i].reshape(s, n, -1), want[i].reshape(s, n, -1), 1e-5)
    _close(got[3].reshape(1, n, -1), want[3].reshape(1, n, -1), 1e-4)
    _close(got[4].reshape(s, n, -1), want[4].reshape(s, n, -1), 1e-4)
    assert torch.equal(got[4][:, :, 3], torch.zeros(s, n, 4))
    z = want[2].reshape(s, n, h, w)
    if kind == "behind":
        assert (z[1] < 0).all() and (z[0] > 0).all()
    if kind == "near_zero":
        assert (z[:, 1].abs() <= 2.4e-7).all() and (z[:, 1] == 0).any()


@pytest.mark.parametrize("case", [CASES[2], CASES[4]], ids=["four_tiles", "near_zero"])
def test_project_gradients_are_the_same_bits_in_any_block_order(libs, case):
    """The build that runs a grid's blocks and a block's threads last to
    first gives d_T and d_depth bit for bit, and so does a second call."""
    args = _inputs(*case[:5], 3, case[5])
    fwd, again, rev = _run(libs[0], *args), _run(libs[0], *args), _run(libs[1], *args)
    for a, b, c in zip(fwd, again, rev):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))


def test_project_depth_takes_k_as_data():
    """``kernels.project_depth`` refuses an intrinsics matrix that requires a
    gradient, and on the CPU is the plain path, with gradients to the depth
    and the transforms."""
    depth, k, k_inv, t, gx, gy, gz = _inputs(2, 2, 9, 11, False, 1)
    with pytest.raises(ValueError):
        kernels.project_depth(depth, k.requires_grad_(), k_inv, t)
    d = depth.requires_grad_()
    tt = t.clone().requires_grad_()
    x, y, z = kernels.project_depth(d, k.detach(), k_inv, tt)
    (x * gx + y * gy + z * gz).sum().backward()
    assert d.grad is not None and tt.grad is not None
    want = project.project_plain(depth.detach(), k.detach(), k_inv, t)
    for got, ref in zip((x, y, z), want):
        assert torch.equal(got, ref)
