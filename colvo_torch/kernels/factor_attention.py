"""FA: CoaT's factorized attention with its convolutional relative position
term (``csrc/factor_attention.cu``), the attention of MPViT's MHCA blocks.

Per frame and head, with q, k, v (N × d) the head's slices of the qkv
projection and cv (N × d) the CRPE term (a depthwise convolution of v):
``out = d^−½ · q · (softmax_N(k)ᵀ · v) + q ∘ cv``, the softmax over the
tokens column by column.

``factor_attention`` chooses by the tensor's device: a CUDA tensor takes
kernel FA (``forward``: three launches; with autograd it also keeps the
head's d × d product and the softmax's column max and sum, and the
backward is ``backward``: three launches, which write ∂qkv in qkv's layout),
a CPU tensor ``factor_attention_plain``. Each call counts as ``FA/fwd``
and each backward as ``FA/bwd`` (``kernels.launch_counts``).

Layout: qkv (F, N, 3·C) with C = heads·d, its last dim (3, heads, d); cv
(F, N, C); both dense, float32 or bfloat16 (one dtype); d at most
``MAX_D``. The output is (F, N, C), as the projection after it takes it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from colvo_torch.kernels import build

MAX_D = 64  # kMaxD of csrc/factor_attention.cu
PAIRS = MAX_D * MAX_D  # d × d sums a CTA keeps in registers (the source's PAIRS · THREADS)
MAX_FRAMES = 65535
WAVES = 8  # CTAs an SM the chunking aims at, in each kernel's grid
H100_SMS = 132  # the SMs assumed where the tensors are not on a card

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class FaArgs(ctypes.Structure):
    """``FaArgs`` of ``csrc/factor_attention.cu``, field for field."""
    _fields_ = [("qkv", _P), ("cv", _P), ("g", _P), ("out", _P), ("dcv", _P), ("ws", _P),
                ("stats", _P), ("frames", _I), ("n", _I), ("heads", _I), ("d", _I),
                ("group", _I), ("chunk", _I), ("tile", _I), ("scale", _F)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/factor_attention.cu``'s
    entry points on a library built from it."""
    if lib.colvo_fa_fwd.argtypes is None:
        for fn in (lib.colvo_fa_fwd, lib.colvo_fa_bwd):
            fn.argtypes = [FaArgs, _I, _P]
            fn.restype = _I
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("factor_attention"))


def _split(qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    f, n, c3 = qkv.shape
    return qkv.view(f, n, 3, heads, c3 // (3 * heads)).unbind(2)


def factor_attention_plain(qkv: torch.Tensor, cv: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain version, in the input's dtype: CoaT's
    ``FactorAtt_ConvRelPosEnc`` after its qkv projection."""
    f, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)  # (F, N, heads, d)
    kv = torch.einsum("fnhc,fnhj->fhcj", torch.softmax(k, dim=1), v)
    att = torch.einsum("fnhc,fhcj->fnhj", q, kv) * q.shape[-1] ** -0.5
    return (att + q * cv.view(q.shape)).reshape(f, n, c3 // 3)


def group(heads: int, d: int) -> int:
    """Heads a CTA serves: the most, a divisor of ``heads``, whose d × d
    sums fit ``PAIRS`` registers a thread."""
    return max(g for g in range(1, heads + 1) if heads % g == 0 and g * d * d <= PAIRS)


def tile_rows(width: int) -> int:
    """Rows of a tile staged in shared memory: about 2,048 elements of the
    head group's ``width`` channels."""
    return max(8, min(128, 2048 // width))


def chunk_rows(n: int, ctas: int, tile: int, sms: int) -> int:
    """Tokens a CTA takes: whole tiles, so that ``ctas`` CTAs a chunk fill
    about ``WAVES`` a card's SM."""
    chunks = max(1, WAVES * sms // ctas)
    return -(-n // (chunks * tile)) * tile


def args(qkv: torch.Tensor, cv: torch.Tensor, out: torch.Tensor, heads: int,
         ws: torch.Tensor | None, stats: torch.Tensor, g: torch.Tensor | None = None,
         dcv: torch.Tensor | None = None) -> FaArgs:
    """The ``FaArgs`` of one call: forward writing ``out``, or with ``g``
    backward writing ∂qkv to ``out`` and ∂cv to ``dcv``; ``ws`` (None: set
    later) the workspace ``workspace`` sizes."""
    f, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    grp, tile = group(heads, d), tile_rows(group(heads, d) * d)
    rows = chunk_rows(n, f * heads // grp, tile, sms(qkv.device))
    return FaArgs(qkv=qkv.data_ptr(), cv=cv.data_ptr(), g=None if g is None else g.data_ptr(),
                  out=out.data_ptr(), dcv=None if dcv is None else dcv.data_ptr(),
                  ws=None if ws is None else ws.data_ptr(), stats=stats.data_ptr(), frames=f, n=n, heads=heads, d=d,
                  group=grp, chunk=rows, tile=tile, scale=d ** -0.5)


def sms(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def workspace(p: FaArgs, device: torch.device) -> torch.Tensor:
    """The reduce's per-chunk sums of the call ``p``, F·heads·chunks·(d² +
    2d) floats."""
    chunks = -(-p.n // p.chunk)
    return build.empty(p.frames * p.heads * chunks * (p.d * p.d + 2 * p.d), torch.float32, device)


def _check(qkv: torch.Tensor, cv: torch.Tensor, heads: int) -> int:
    if qkv.device.type != "cuda" or cv.device != qkv.device:
        raise ValueError(f"factor attention kernel needs CUDA tensors on one device, got "
                         f"{qkv.device} and {cv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16) or cv.dtype != qkv.dtype:
        raise TypeError(f"factor attention kernel takes float32 or bfloat16 tensors of one "
                        f"dtype, got {qkv.dtype} and {cv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"factor attention kernel takes qkv (F, N, 3·heads·d), got "
                         f"{tuple(qkv.shape)} with {heads} heads")
    d = qkv.shape[2] // (3 * heads)
    if cv.shape != (qkv.shape[0], qkv.shape[1], heads * d):
        raise ValueError(f"factor attention kernel takes cv (F, N, C), got {tuple(cv.shape)}")
    if not (qkv.is_contiguous() and cv.is_contiguous()):
        raise ValueError("factor attention kernel takes dense qkv and cv")
    if d > MAX_D or qkv.shape[0] > MAX_FRAMES:
        raise ValueError(f"factor attention kernel takes d ≤ {MAX_D} and at most "
                         f"{MAX_FRAMES} frames, got {tuple(qkv.shape)} with {heads} heads")
    return d


def _run(entry: str, p: FaArgs, bf16: bool, device: torch.device, what: str) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_lib(), entry)(p, int(bf16), stream)
    if err != 0:
        raise ValueError(f"factor attention {what} launch failed (cudaError {err})")


def forward(qkv: torch.Tensor, cv: torch.Tensor, heads: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (F, N, C), the heads' KV, max and sum (F, heads, d² + 2d)
    float32): the forward's three launches on CUDA tensors."""
    d = _check(qkv, cv, heads)
    f, n, _ = qkv.shape
    out = build.empty(f * n * heads * d, qkv.dtype, qkv.device).view(f, n, heads * d)
    stats = build.empty(f * heads * (d * d + 2 * d), torch.float32,
                        qkv.device).view(f, heads, d * d + 2 * d)
    p = args(qkv, cv, out, heads, None, stats)
    ws = workspace(p, qkv.device)
    p.ws = ws.data_ptr()
    _run("colvo_fa_fwd", p, qkv.dtype == torch.bfloat16, qkv.device, "forward")
    build.count_launch("FA/fwd")
    return out, stats


def backward(qkv: torch.Tensor, cv: torch.Tensor, stats: torch.Tensor, g: torch.Tensor,
             heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(∂qkv in qkv's layout, ∂cv): the backward's three launches."""
    _check(qkv, cv, heads)
    g = g.contiguous().to(qkv.dtype)
    dqkv = build.empty(qkv.numel(), qkv.dtype, qkv.device).view(qkv.shape)
    dcv = build.empty(cv.numel(), cv.dtype, cv.device).view(cv.shape)
    p = args(qkv, cv, dqkv, heads, None, stats, g, dcv)
    ws = workspace(p, qkv.device)
    p.ws = ws.data_ptr()
    _run("colvo_fa_bwd", p, qkv.dtype == torch.bfloat16, qkv.device, "backward")
    build.count_launch("FA/bwd")
    return dqkv, dcv


class _FactorAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, cv, heads):
        out, stats = forward(qkv, cv, heads)
        ctx.save_for_backward(qkv, cv, stats)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, cv, stats = ctx.saved_tensors
        dqkv, dcv = backward(qkv, cv, stats, g, ctx.heads)
        return dqkv, dcv, None


def factor_attention(qkv: torch.Tensor, cv: torch.Tensor, heads: int) -> torch.Tensor:
    """Factorized attention of qkv (F, N, 3·C) with the CRPE term cv (F, N,
    C) → (F, N, C): kernel FA for CUDA tensors, ``factor_attention_plain``
    for CPU tensors."""
    if qkv.device.type == "cpu":
        return factor_attention_plain(qkv, cv, heads)
    qkv, cv = qkv.contiguous(), cv.contiguous()
    if build.needs_grad(qkv, cv):
        return _FactorAttention.apply(qkv, cv, heads)
    return forward(qkv, cv, heads)[0]
