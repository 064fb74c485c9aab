"""T: source cotangent of bilinear sampling (``csrc/scatter.cu``).

``scatter_multi`` is the kernel's wrapper: a CUDA tensor launches the
kernel once for up to ``MAX_DESCS`` plane sets (the geo scales of a step),
after one memset of the one buffer that holds their gradients (exact for
any warp, not deterministic across runs), and any error raises. Under
``torch.use_deterministic_algorithms(True)`` it launches the deterministic
variant instead, which gives the same bits on every run: each tap's term
rounded on its own to int64 in a per-plane fixed point and summed in
integers, in thread-block clusters that hold each source plane's sums in
shared memory, counted as ``C<c>/det`` (one launch); plane sets too large
for a cluster take a device-memory path in the same call, counted as
``C<c>/det/global``; the plan of a set of shapes (paths, workspace,
shared memory) is the entry point's own, asked once and kept. The
buffers the entry points write or zero whole are not filled, also
under deterministic algorithms. ``scatter_multi_plain_fixed`` computes
the deterministic variant's bits in PyTorch (the tests and ``chip_smoke.py``
hold the kernel to it). A CPU tensor takes ``scatter_multi_plain``, a loop
of ``scatter_plain``, the autograd transpose of the sampler's gather
written with ``index_add_`` (deterministic on the CPU), in both modes.
``scatter`` is its one-plane-set call. ``launches`` counts kernel
launches.

Layout: x, y (N, h, w) f32; g (N, C, h, w) f32 → d_src (N, C, H, W) f32.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import List, NamedTuple, Sequence, Tuple

import torch

from colvo_torch.geometry.ops import bilinear_taps
from colvo_torch.kernels import build

# Launches of the CUDA kernel, keyed "C<c>" (float atomics), "C<c>/det"
# (the cluster kernel) or "C<c>/det/global" (the device-memory path).
launches: Counter = Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# Descriptors one launch takes (kMaxDescs of csrc/scatter.cu).
MAX_DESCS = 8


class ScatterDesc(ctypes.Structure):
    """``ScatterDesc`` of ``csrc/scatter.cu``, field for field."""
    _fields_ = [("x", _P), ("y", _P), ("g", _P), ("dsrc", _P), ("n", _I), ("c", _I),
                ("h_src", _I), ("w_src", _I), ("h_out", _I), ("w_out", _I),
                ("tiles_x", _I), ("tiles_per_plane", _I), ("block0", _I),
                ("parts", _I), ("band_rows", _I)]


class ScatterParams(ctypes.Structure):
    """``ScatterParams`` of ``csrc/scatter.cu``, passed by value."""
    _fields_ = [("d", ScatterDesc * MAX_DESCS), ("n_desc", _I)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/scatter.cu``'s entry
    points on a library built from it."""
    fn = lib.colvo_bilinear_scatter_multi
    if fn.argtypes is None:
        fn.argtypes = [ScatterParams, _P, _L, _P]
        fn.restype = _I
        det = lib.colvo_bilinear_scatter_multi_det
        det.argtypes = [ScatterParams, _L, _P, _L, _P]
        det.restype = _I
        plan = lib.colvo_scatter_det_plan
        plan.argtypes = [ctypes.POINTER(ScatterParams), ctypes.POINTER(_I),
                         ctypes.POINTER(_L), ctypes.POINTER(_I), ctypes.POINTER(_I)]
        plan.restype = _I
        occ = lib.colvo_scatter_det_occupancy
        occ.argtypes = [_I, ctypes.POINTER(_I)]
        occ.restype = _I
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("scatter"))


class DetPlan(NamedTuple):
    """The deterministic variant's plan, as its entry point makes it."""
    paths: int  # bit 0: the cluster kernel runs; bit 1: the global path does
    ws_longs: int  # the global path's int64 workspace
    smem_bytes: int  # the cluster kernel's dynamic shared memory a CTA
    cluster: int  # its CTAs a cluster
    parts: Tuple[int, ...]  # CTAs a plane, by descriptor (0: the global path)


def det_plan(lib: ctypes.CDLL, params: ScatterParams) -> DetPlan:
    """The deterministic variant's plan for ``params`` (only their shapes
    count), as the entry point of ``lib`` makes it on the current device."""
    paths, ws, smem, cluster = _I(), _L(), _I(), _I()
    err = lib.colvo_scatter_det_plan(ctypes.byref(params), ctypes.byref(paths), ctypes.byref(ws),
                                     ctypes.byref(smem), ctypes.byref(cluster))
    if err != 0:
        raise RuntimeError(f"bilinear_scatter deterministic plan failed: cudaError {err}")
    return DetPlan(paths.value, ws.value, smem.value, cluster.value,
                   tuple(params.d[i].parts for i in range(params.n_desc)))


@functools.lru_cache(maxsize=64)
def _det_plan_of(device_index: int, shapes: Tuple[Tuple[int, ...], ...]) -> DetPlan:
    """``det_plan`` of the built library for descriptors of these (n, c,
    h_src, w_src, h_out, w_out) on card ``device_index``: a step's shapes
    repeat, so the wrapper plans once for them."""
    params = ScatterParams(n_desc=len(shapes))
    for i, shape in enumerate(shapes):
        d = params.d[i]
        d.n, d.c, d.h_src, d.w_src, d.h_out, d.w_out = shape
    with torch.cuda.device(device_index):
        return det_plan(_lib(), params)


def det_occupancy(smem_bytes: int) -> int:
    """Clusters of the deterministic kernel the card holds at once with
    ``smem_bytes`` of shared memory a CTA (``cudaOccupancyMaxActiveClusters``)."""
    n = _I()
    err = _lib().colvo_scatter_det_occupancy(smem_bytes, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {err}")
    return n.value


def _empty(numel: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A new (numel,) tensor, left unfilled also under deterministic
    algorithms (which fill ``torch.empty``'s memory): the entry points
    write or zero every cell of what they get, so a fill would be a wasted
    pass over it."""
    storage = torch.UntypedStorage(numel * dtype.itemsize, device=device)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, (numel,), (1,))


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


_INF_BITS, _ABS_BITS = 0x7F800000, 0x7FFFFFFF


def _pow2(s: torch.Tensor) -> torch.Tensor:
    """2^s as float32 from its bits (the kernel's ``pow2``), -126 ≤ s ≤ 127."""
    return ((s + 127) << 23).to(torch.int32).view(torch.float32)


def _factors(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two float factors of 2^s: 2^(s/2) and 2^(s - s/2), with C's
    division that truncates toward zero."""
    half = torch.div(s, 2, rounding_mode="trunc")
    return _pow2(half), _pow2(s - half)


def fixed_point_terms(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, h_src: int,
                      w_src: int):
    """The deterministic kernel's terms: (cell index into the flattened
    (N·C·h_src·w_src) planes, int64 term) for each of a pixel's four taps,
    each term rounded on its own in its plane's fixed point; then a bool
    per plane that is NaN (max |g| inf or NaN, or a non-finite term of a
    pixel with g ≠ 0), the plane's max |g| bits, and its shift s."""
    n, c, h, w = g.shape
    x0, x1, wx = bilinear_taps(x, w_src)
    y0, y1, wy = bilinear_taps(y, h_src)
    # the plane's max |g| by the bits of |g| (NaN above inf above finite)
    mb = (g.reshape(n * c, -1).view(torch.int32) & _ABS_BITS).amax(1).to(torch.int64)
    e = mb.clamp(min=1 << 23).bitwise_right_shift(23) - 126
    f = (4 * h * w - 1).bit_length()
    s = 62 - e - f
    bad = mb >= _INF_BITS
    scale_a, scale_b = (t.reshape(n, c, 1, 1) for t in _factors(torch.where(bad | (mb == 0), 0, s)))
    nz = g != 0
    base = (torch.arange(n * c, device=g.device) * (h_src * w_src)).reshape(n, c, 1, 1)
    ux, uy = (1.0 - wx)[:, None], (1.0 - wy)[:, None]
    vx, vy = wx[:, None], wy[:, None]
    idx, q = [], []
    for yy, xx, t in ((y0, x0, g * ux * uy), (y0, x1, g * vx * uy),
                      (y1, x0, g * ux * vy), (y1, x1, g * vx * vy)):
        finite = torch.isfinite(t)
        bad |= (nz & ~finite).reshape(n * c, -1).any(1)
        v = torch.where(nz & finite, t, 0.0) * scale_a * scale_b
        q.append(torch.round(v).to(torch.int64))
        idx.append((base + (yy * w_src + xx)[:, None]).expand(n, c, h, w))
    return torch.stack(idx).reshape(-1), torch.stack(q).reshape(-1), bad, mb, s


def from_fixed_point(sums: torch.Tensor, bad: torch.Tensor, mb: torch.Tensor,
                     s: torch.Tensor, shape) -> torch.Tensor:
    """int64 sums (N·C·h_src·w_src) → d_src (N, C, h_src, w_src) float32:
    float(sum) · 2^-s by the kernel's two factors, NaN in a bad plane, 0
    in a plane with g = 0 everywhere."""
    fa, fb = _factors(torch.where(bad | (mb == 0), 0, -s))
    fa = torch.where(bad, float("nan"), torch.where(mb == 0, 0.0, fa))
    fb = torch.where(mb == 0, 0.0, fb)
    out = sums.reshape(len(mb), -1).to(torch.float32) * fa[:, None] * fb[:, None]
    return out.reshape(shape)


def scatter_plain_fixed(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                        h_src: int, w_src: int) -> torch.Tensor:
    """Plain version of the deterministic kernel, bit for bit: the terms of
    ``fixed_point_terms`` summed by an int64 ``index_add_`` (exact in any
    order), then ``from_fixed_point``."""
    idx, q, bad, mb, s = fixed_point_terms(x, y, g, h_src, w_src)
    sums = torch.zeros(g.shape[0] * g.shape[1] * h_src * w_src, dtype=torch.int64,
                       device=g.device).index_add_(0, idx, q)
    return from_fixed_point(sums, bad, mb, s, (*g.shape[:2], h_src, w_src))


def scatter_multi_plain_fixed(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                              gs: Sequence[torch.Tensor],
                              src_hws: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``scatter_plain_fixed`` per plane set: the deterministic
    ``scatter_multi``'s bits."""
    return [scatter_plain_fixed(x, y, g, *hw) for x, y, g, hw in zip(xs, ys, gs, src_hws)]


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
                plan = _det_plan_of(device.index, tuple(
                    (d.n, d.c, d.h_src, d.w_src, d.h_out, d.w_out)
                    for d in params.d[:params.n_desc]))
                ws = _empty(plan.ws_longs, torch.int64, device) if plan.ws_longs else None
                err = _lib().colvo_bilinear_scatter_multi_det(
                    params, buf.numel(), ws.data_ptr() if ws is not None else None,
                    plan.ws_longs, stream)
                if err != 0:
                    raise RuntimeError(f"bilinear_scatter kernel launch failed: cudaError {err}")
                if plan.paths & 1:
                    launches[f"C{c}/det"] += 1
                if plan.paths & 2:
                    launches[f"C{c}/det/global"] += 1
            else:
                err = _lib().colvo_bilinear_scatter_multi(params, buf.data_ptr(), buf.numel(),
                                                          stream)
                if err != 0:
                    raise RuntimeError(f"bilinear_scatter kernel launch failed: cudaError {err}")
                launches[f"C{c}"] += 1
        results += outs
    return results


def multi_params(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor],
                 gs: Sequence[torch.Tensor], src_hws: Sequence[Tuple[int, int]]
                 ) -> Tuple[ScatterParams, torch.Tensor, List[torch.Tensor]]:
    """The descriptor table of one launch for up to ``MAX_DESCS`` checked
    plane sets of one channel count, the one buffer that holds their
    gradients (left for the C entry point to fill) and its views."""
    c = gs[0].shape[1]
    sizes = [g.shape[0] * c * h * w for g, (h, w) in zip(gs, src_hws)]
    buf = _empty(sum(sizes), torch.float32, gs[0].device)
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
