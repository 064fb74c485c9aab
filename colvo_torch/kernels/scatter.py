"""T: source cotangent of bilinear sampling (``csrc/scatter.cu``).

``scatter_multi`` is the kernel's wrapper: a CUDA tensor launches the
kernel once for up to ``MAX_DESCS`` plane sets (the geo scales of a step),
after one memset of the one buffer that holds their gradients (exact for
any warp, not deterministic across runs), and any error raises; under
``torch.use_deterministic_algorithms(True)`` it launches the deterministic
variant instead (fixed-point int64 atomics: the same bits on every run;
``csrc/scatter.cu`` says how), counted as ``C<c>/det``. A CPU tensor takes
``scatter_multi_plain``, a loop of ``scatter_plain``, the autograd
transpose of the sampler's gather written with ``index_add_``
(deterministic on the CPU). ``scatter`` is its one-plane-set call.
``launches`` counts kernel launches (a plane-set launch of the
deterministic variant is one count for its four operations).

Layout: x, y (N, h, w) f32; g (N, C, h, w) f32 → d_src (N, C, H, W) f32.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, Sequence, Tuple

import torch

from colvo_torch.geometry.ops import bilinear_taps
from colvo_torch.kernels import build

# Launches of the CUDA kernel, keyed "C<c>" (float atomics) or "C<c>/det".
launches: Counter = Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# Descriptors one launch takes (kMaxDescs of csrc/scatter.cu).
MAX_DESCS = 8


class ScatterDesc(ctypes.Structure):
    """``ScatterDesc`` of ``csrc/scatter.cu``, field for field."""
    _fields_ = [("x", _P), ("y", _P), ("g", _P), ("dsrc", _P), ("n", _I), ("c", _I),
                ("h_src", _I), ("w_src", _I), ("h_out", _I), ("w_out", _I),
                ("tiles_x", _I), ("tiles_per_plane", _I), ("block0", _I)]


class ScatterParams(ctypes.Structure):
    """``ScatterParams`` of ``csrc/scatter.cu``, passed by value."""
    _fields_ = [("d", ScatterDesc * MAX_DESCS), ("n_desc", _I)]


def _lib() -> ctypes.CDLL:
    lib = build.library("scatter")
    fn = lib.colvo_bilinear_scatter_multi
    if fn.argtypes is None:
        fn.argtypes = [ScatterParams, _P, _L, _P]
        fn.restype = _I
        det = lib.colvo_bilinear_scatter_multi_det
        det.argtypes = [ScatterParams, _P, _L, _P, _P]
        det.restype = _I
    return lib


def det_workspace(params: ScatterParams, buf: torch.Tensor) -> torch.Tensor:
    """The deterministic variant's workspace for ``params`` over ``buf``:
    an int64 accumulator a cell of ``buf``, then a 32-bit slot a plane
    (the entry point zeroes it)."""
    planes = sum(params.d[i].n * params.d[i].c for i in range(params.n_desc))
    return torch.empty(buf.numel() + (planes + 1) // 2, dtype=torch.int64, device=buf.device)


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


def scatter_multi_plain(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor],
                        src_hws: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Plain version of ``scatter_multi``: ``scatter_plain`` per plane set."""
    return [scatter_plain(x, y, g, *hw) for x, y, g, hw in zip(xs, ys, gs, src_hws)]


def _check(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"bilinear_scatter kernel needs CUDA tensors, got {g.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("bilinear_scatter kernel takes float32 coords and cotangent")
    if g.dim() != 4 or x.shape != y.shape or x.shape != (g.shape[0],) + g.shape[2:]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} y {tuple(y.shape)} g {tuple(g.shape)}")
    if not (x.is_contiguous() and y.is_contiguous() and g.is_contiguous()):
        raise ValueError("bilinear_scatter kernel needs contiguous inputs")
    if x.device != g.device or y.device != g.device:
        raise ValueError("coords and cotangent must share one device")


def _scatter_multi_cuda(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor],
                        src_hws: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    if not len(xs) == len(ys) == len(gs) == len(src_hws):
        raise ValueError("scatter_multi takes one x, y, g and source size per plane set")
    for x, y, g in zip(xs, ys, gs):
        _check(x, y, g)
    det = torch.are_deterministic_algorithms_enabled()
    device, c = gs[0].device, gs[0].shape[1]
    if any(g.device != device for g in gs) or any(g.shape[1] != c for g in gs):
        raise ValueError("scatter_multi takes plane sets of one device and one channel count")
    results: List[torch.Tensor] = []
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in range(0, len(gs), MAX_DESCS):
        params, buf, outs = multi_params(xs[lo:lo + MAX_DESCS], ys[lo:lo + MAX_DESCS],
                                         gs[lo:lo + MAX_DESCS], src_hws[lo:lo + MAX_DESCS])
        with torch.cuda.device(device):
            if det:
                ws = det_workspace(params, buf)
                err = _lib().colvo_bilinear_scatter_multi_det(params, buf.data_ptr(), buf.numel(),
                                                              ws.data_ptr(), stream)
            else:
                err = _lib().colvo_bilinear_scatter_multi(params, buf.data_ptr(), buf.numel(),
                                                          stream)
        if err != 0:
            raise RuntimeError(f"bilinear_scatter kernel launch failed: cudaError {err}")
        launches[f"C{c}/det" if det else f"C{c}"] += 1
        results += outs
    return results


def multi_params(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                 gs: Sequence[torch.Tensor], src_hws: Sequence[Tuple[int, int]]
                 ) -> Tuple[ScatterParams, torch.Tensor, List[torch.Tensor]]:
    """The descriptor table of one launch for up to ``MAX_DESCS`` checked
    plane sets of one channel count, the one buffer that holds their
    gradients (left for the C entry point to zero) and its views."""
    c = gs[0].shape[1]
    sizes = [g.shape[0] * c * h * w for g, (h, w) in zip(gs, src_hws)]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=gs[0].device)
    params = ScatterParams(n_desc=len(gs))
    results: List[torch.Tensor] = []
    off = 0
    for i, (x, y, g, (h, w)) in enumerate(zip(xs, ys, gs, src_hws)):
        out = buf[off:off + sizes[i]].view(g.shape[0], c, h, w)
        off += sizes[i]
        d = params.d[i]
        d.x, d.y, d.g, d.dsrc = x.data_ptr(), y.data_ptr(), g.data_ptr(), out.data_ptr()
        d.n, d.c, d.h_src, d.w_src, d.h_out, d.w_out = g.shape[0], c, h, w, *x.shape[1:]
        results.append(out)
    return params, buf, results


def scatter_multi(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                  gs: Sequence[torch.Tensor],
                  src_hws: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Cotangents ``gs[i]`` (N_i, C, h_i, w_i) of samples at (``xs[i]``,
    ``ys[i]``) → gradients of the (N_i, C, *src_hws[i]) sources: one launch
    for up to ``MAX_DESCS`` plane sets of one channel count on CUDA tensors
    (views into one zeroed buffer), the plain version on CPU tensors."""
    if gs[0].device.type == "cpu":
        return scatter_multi_plain(xs, ys, gs, src_hws)
    return _scatter_multi_cuda(xs, ys, gs, src_hws)


def scatter(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
            h_src: int, w_src: int) -> torch.Tensor:
    """Cotangent g (N, C, h, w) of samples at (x, y) → gradient of the
    (N, C, h_src, w_src) source: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    return scatter_multi([x], [y], [g], [(h_src, w_src)])[0]
