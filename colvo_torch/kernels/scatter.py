"""T: source cotangent of bilinear sampling (``csrc/scatter.cu``).

``scatter`` is the kernel's wrapper: a CUDA tensor launches the kernel
(four float atomics per tap set, exact for any warp, not deterministic
across runs) and any error raises; a CPU tensor takes ``scatter_plain``,
the autograd transpose of the sampler's gather written with ``index_add_``.
``launches`` counts kernel launches.

Layout: x, y (N, h, w) f32; g (N, C, h, w) f32 → d_src (N, C, H, W) f32.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from colvo_torch.geometry.ops import bilinear_taps
from colvo_torch.kernels import build

# Launches of the CUDA kernel, keyed "C<c>".
launches: Counter = Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("scatter")
    fn = lib.colvo_bilinear_scatter
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def scatter_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                  h_src: int, w_src: int) -> torch.Tensor:
    """Plain version: d src[r, c] = Σ_p g_p·w_p over the four bilinear taps,
    by ``index_add_`` into the flattened planes (zero-cotangent pixels
    add nothing, as in the kernel)."""
    n, c = g.shape[:2]
    h, w = h_src, w_src
    x0, x1, wx = bilinear_taps(x, w)
    y0, y1, wy = bilinear_taps(y, h)
    base = (torch.arange(n * c, device=g.device) * (h * w)).reshape(n, c, 1)
    nz = g != 0
    out = torch.zeros(n * c * h * w, dtype=g.dtype, device=g.device)
    for yy, xx, wt in (
        (y0, x0, (1.0 - wx) * (1.0 - wy)),
        (y0, x1, wx * (1.0 - wy)),
        (y1, x0, (1.0 - wx) * wy),
        (y1, x1, wx * wy),
    ):
        idx = base + (yy * w + xx).reshape(n, 1, -1)
        val = torch.where(nz, g * wt[:, None], 0.0)
        out.index_add_(0, idx.reshape(-1), val.reshape(-1))
    return out.reshape(n, c, h, w)


def _scatter_cuda(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                  h_src: int, w_src: int) -> torch.Tensor:
    if g.device.type != "cuda":
        raise ValueError(f"bilinear_scatter kernel needs CUDA tensors, got {g.device}")
    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            "bilinear_scatter adds with float atomics and is not deterministic; "
            "it cannot run under torch.use_deterministic_algorithms(True)"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("bilinear_scatter kernel takes float32 coords and cotangent")
    n, c = g.shape[:2]
    if g.dim() != 4 or x.shape != y.shape or x.shape != (n,) + g.shape[2:]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} y {tuple(y.shape)} g {tuple(g.shape)}")
    if not (x.is_contiguous() and y.is_contiguous() and g.is_contiguous()):
        raise ValueError("bilinear_scatter kernel needs contiguous inputs")
    if x.device != g.device or y.device != g.device:
        raise ValueError("coords and cotangent must share one device")
    out = torch.zeros((n, c, h_src, w_src), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = _lib().colvo_bilinear_scatter(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr(),
            n, c, h_src, w_src, x.shape[1], x.shape[2], stream,
        )
    if err != 0:
        raise RuntimeError(f"bilinear_scatter kernel launch failed: cudaError {err}")
    launches[f"C{c}"] += 1
    return out


def scatter(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
            h_src: int, w_src: int) -> torch.Tensor:
    """Cotangent g (N, C, h, w) of samples at (x, y) → gradient of the
    (N, C, h_src, w_src) source: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if g.device.type == "cpu":
        return scatter_plain(x, y, g, h_src, w_src)
    return _scatter_cuda(x, y, g, h_src, w_src)
