"""Kernel F's CUDA source (``csrc/fused_loss.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py`` (a ``std::thread`` per CUDA thread of a block,
``std::barrier`` for ``__syncthreads``, a byte buffer per block for its
dynamic shared memory, plain copies for ``cp.async``; 4 SMs, so a frame
splits into several row ranges). That executes the kernels' own indexing,
rings, walks and edge handling, which the plain versions do not, against
those plain versions, at shapes that cut the strips, chunks and row
ranges and at windows that take every branch. Float arithmetic differs
from the card's, so the card's own check stays ``chip_smoke.py``; the
tolerances are the same.
"""

import ctypes

import numpy as np
import pytest
import torch

from colvo_torch.kernels import fused_loss
from colvo_torch.kernels.sampler import sample_plain
from colvo_torch.losses.photometric import lcc_calibrate
from cuda_emu import CP_ASYNC, SHIM, compile_source, workdir


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    d, cxx = workdir(tmp_path_factory, "fused_emu", {"cuda_runtime.h": SHIM,
                                                     "cp_async.cuh": CP_ASYNC})
    lib = compile_source(d, cxx, "fused_loss")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.colvo_fused_err_fwd.argtypes = [p, ll, p, ll, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.colvo_fused_err_bwd.argtypes = [p, ll, p, ll, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    return lib


def _inputs(n, c, h, w, hs, ws, seed):
    """A source one frame longer than used (a batch stride that is not the
    frame's size), a relit target, near-identity coords scaled to the
    source with noise, out-of-bounds and ±1e20 coords."""
    rng = np.random.default_rng(seed)
    src = torch.tensor(rng.random((n + 1, c, hs, ws), dtype=np.float32))[1:]
    tgt = torch.tensor(0.8 * rng.random((n, c, h, w), dtype=np.float32) + 0.1)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    x = gx[None] * (ws / w) + rng.normal(0, 3.0, (n, h, w)).astype(np.float32)
    y = gy[None] * (hs / h) + rng.normal(0, 3.0, (n, h, w)).astype(np.float32)
    x[0, 1, 3], x[0, 2, 5], y[0, 3, 2] = 1e20, -1e20, 1e20
    g = torch.tensor(rng.normal(size=(n, h, w)).astype(np.float32))
    g[:, :2] = 0.0
    return src, tgt, torch.tensor(x), torch.tensor(y), g


@pytest.mark.parametrize("n,c,h,w,hs,ws,window", [
    (2, 3, 36, 50, 40, 56, 15),   # the main window; 36 rows split into row ranges
    (1, 3, 150, 70, 97, 131, 4),  # even window (lo ≠ hi), several strips and ranges
    (1, 1, 30, 20, 25, 33, 31),   # a window wider than the image
    (1, 5, 20, 30, 22, 33, 0),    # no LCC; a channel count compiled at run time
    (2, 2, 9, 7, 12, 10, 3),      # an image smaller than a chunk and a strip
])
def test_fused_kernel_source_matches_plain_versions(lib, n, c, h, w, hs, ws, window):
    """e ≤5e-5 abs; gx, gy ≤1e-4 of max off the pixels within 1e-5 of an
    L1 sign change, which may be ≤0.1 % of all (the card's tolerances,
    chip_smoke.py)."""
    torch.set_num_threads(2)
    src, tgt, x, y, g = _inputs(n, c, h, w, hs, ws, 40 + window)
    e = torch.full((n, h, w), float("nan"))
    gx, gy = torch.full_like(e, float("nan")), torch.full_like(e, float("nan"))
    frames = (src.data_ptr(), src.stride(0), tgt.data_ptr(), tgt.stride(0), x.data_ptr(),
              y.data_ptr())
    assert lib.colvo_fused_err_fwd(*frames, e.data_ptr(), n, c, hs, ws, h, w, window, 0.85,
                                   None) == 0
    assert lib.colvo_fused_err_bwd(*frames, g.data_ptr(), gx.data_ptr(), gy.data_ptr(), n, c,
                                   hs, ws, h, w, window, 0.85, None) == 0
    torch.testing.assert_close(e, fused_loss.err_plain(src, tgt, x, y, window, 0.85),
                               atol=5e-5, rtol=0)
    pgx, pgy = fused_loss.err_bwd_plain(src, tgt, x, y, g, window, 0.85)
    t = tgt.permute(0, 2, 3, 1)
    w_hat = sample_plain(src, x, y, False)[0].permute(0, 2, 3, 1)
    if window:
        w_hat = lcc_calibrate(w_hat, t, "affine", window)
    ties = (w_hat - t).abs().amin(-1) < 1e-5
    assert ties.float().mean().item() <= 1e-3
    scale = max(pgx.abs().max().item(), pgy.abs().max().item())
    for got, want in ((gx, pgx), (gy, pgy)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[~ties], want[~ties], atol=1e-4 * scale, rtol=0)
