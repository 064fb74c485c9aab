"""Kernel FA's CUDA source (``csrc/factor_attention.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py``, with its bfloat16 header (``BF16``), and fed by
the wrapper's own ``factor_attention.args``. That runs both directions'
reduce over several token chunks (the chunking aims at a card's worth of
CTAs, so these small calls split N finely), the fixed-order combine, the tiles' edges and
the strided q, k and v slices against the plain
``factor_attention_plain`` and its autograd gradient in float64: the
kernel in float32 may be no farther from it than twice what the float32
plain path is, plus a floor relative to the largest magnitude. Built
with ``-DSHIM_REVERSE`` (blocks and threads last to first) the outputs
are the same bits.
"""

import importlib

import pytest
import torch

from cuda_emu import BF16, SHIM, compile_source, workdir

# the module (the package re-exports its function under the same name)
fa = importlib.import_module("colvo_torch.kernels.factor_attention")
FLOOR = 1e-6  # relative to the largest magnitude of the float64 output


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """FA as built for the card, and with the blocks and threads reversed."""
    d, cxx = workdir(tmp_path_factory, "fa_emu", {"cuda_runtime.h": SHIM, "cuda_bf16.h": BF16})
    return tuple(fa.bind(compile_source(d, cxx, "factor_attention", *flags))
                 for flags in ((), ("-DSHIM_REVERSE",)))


def _inputs(f, n, heads, d, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(f, n, 3 * heads * d, generator=gen, dtype=torch.float64)
    qkv[..., heads * d:2 * heads * d] *= 3.0  # a peaked softmax
    cv = torch.randn(f, n, heads * d, generator=gen, dtype=torch.float64)
    g = torch.randn(f, n, heads * d, generator=gen, dtype=torch.float64)
    return qkv.to(dtype), cv.to(dtype), g.to(dtype)


def _kernel(lib, qkv, cv, g, heads):
    """(out, ∂qkv, ∂cv) through ``lib``, into buffers of NaN."""
    f, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    out = torch.full((f, n, heads * d), float("nan"), dtype=qkv.dtype)
    stats = torch.full((f, heads, d * d + 2 * d), float("nan"))
    p = fa.args(qkv, cv, out, heads, None, stats)
    ws = fa.workspace(p, qkv.device).fill_(float("nan"))
    p.ws = ws.data_ptr()
    bf16 = int(qkv.dtype == torch.bfloat16)
    assert -(-n // p.chunk) > 1 or n <= p.tile  # the reduce over several chunks
    assert lib.colvo_fa_fwd(p, bf16, None) == 0
    dqkv, dcv = torch.full_like(qkv, float("nan")), torch.full_like(cv, float("nan"))
    ws.fill_(float("nan"))
    p = fa.args(qkv, cv, dqkv, heads, ws, stats, g, dcv)
    assert lib.colvo_fa_bwd(p, bf16, None) == 0
    return out, dqkv, dcv


def _plain(qkv, cv, g, heads, dtype):
    qkv = qkv.to(dtype).requires_grad_(True)
    cv = cv.to(dtype).requires_grad_(True)
    out = fa.factor_attention_plain(qkv, cv, heads)
    dqkv, dcv = torch.autograd.grad(out, (qkv, cv), g.to(dtype))
    return out.detach(), dqkv, dcv


def _gap(a, b):
    return (a.double() - b.double()).abs().max().item()


# (frames, tokens, heads, d): MPViT-Small's head widths, the stage-0 width
# over two reduce chunks and a ragged last tile, 8 heads of 36 in four
# groups of two a CTA, one head of the widest d
CASES = [(2, 1100, 2, 8), (2, 150, 3, 27), (1, 80, 2, 36), (1, 70, 8, 36), (1, 37, 1, 64)]


@pytest.mark.parametrize("f,n,heads,d", CASES, ids=[f"{c[0]}x{c[1]}-h{c[2]}-d{c[3]}"
                                                    for c in CASES])
def test_fa_source_matches_plain_path(libs, f, n, heads, d):
    """out, ∂qkv and ∂cv no farther from the float64 plain path than twice
    the float32 plain path's distance plus ``FLOOR``; every element
    written; the same bits with blocks and threads reversed."""
    qkv, cv, g = _inputs(f, n, heads, d, seed=f * 1000 + n + d)
    got = _kernel(libs[0], qkv, cv, g, heads)
    ref = _plain(qkv, cv, g, heads, torch.float64)
    f32 = _plain(qkv, cv, g, heads, torch.float32)
    for name, a, r, b in zip(("out", "dqkv", "dcv"), got, ref, f32):
        assert torch.isfinite(a).all(), name
        scale = r.abs().max().item()
        assert _gap(a, r) <= 2 * _gap(b, r) + FLOOR * scale, (name, _gap(a, r), _gap(b, r))
    for a, b in zip(got, _kernel(libs[1], qkv, cv, g, heads)):
        assert torch.equal(a, b)


def test_fa_source_bf16(libs):
    """bfloat16 storage, float32 arithmetic: within the rounding of the
    bfloat16 output (2⁻⁸ of the largest magnitude, twice) of the float64
    plain path on the same bfloat16 inputs."""
    qkv, cv, g = _inputs(2, 300, 2, 16, seed=5, dtype=torch.bfloat16)
    got = _kernel(libs[0], qkv, cv, g, 2)
    ref = _plain(qkv.double(), cv.double(), g.double(), 2, torch.float64)
    for name, a, r in zip(("out", "dqkv", "dcv"), got, ref):
        assert a.dtype == torch.bfloat16
        assert _gap(a, r) <= 2 * 2.0 ** -8 * r.abs().max().item(), name
