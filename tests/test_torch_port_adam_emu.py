"""Kernel A's CUDA source (``csrc/adam.cu``) on the CPU.

The source is compiled with the host's C++ compiler against the CUDA shim
of ``tests/cuda_emu.py`` (a ``std::thread`` per CUDA thread, barriers for
``__syncthreads``; the shim reports 4 SMs, so the persistent grid is 16
CTAs and a list of more chunks walks them at a stride), with its bfloat16
header, and fed by the wrapper's own ``adam.batches`` and
``adam.step_args``. That runs the table's build (the training models'
lists too), the chunks' walk (a chunk's first tensor, the search where
several tensors share a chunk, the 16-byte quads and the element-wise
ones of misaligned or short tensors), the float64 sums and the last CTA's
sum of the partials, and the step counts' increment, against the plain
chain on the same tensors: A/step bit for bit, the norm within 1e-6 of
float64's. The chain's square root is taken correctly rounded, as the
card's is (PyTorch's CPU kernel for ``torch.sqrt`` is not: a few elements
in 10,000 come out an ulp apart). Built with ``-DSHIM_REVERSE`` (the
blocks of a grid and the threads of a block run last to first) every
output is the same bits.
"""

import ctypes
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from colvo_torch.kernels import adam
from colvo_torch.config import ColvoConfig
from colvo_torch.models import ColVOModel
from cuda_emu import BF16, SHIM, compile_source, workdir

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("colvo_r18_gn", "colvo_dav2_vitl", "colvo_mpvit_s")

# Element counts that mix what the models' lists hold: 1-element tensors,
# odd lengths, a quad exactly, and tensors of many chunks.
SIZES = (1, 3, 4, 5, 7, 8, 33, 1, 1000, 4097, 2, 70001, 64, 1, 9)


def _model_numels(name):
    """The parameter sizes of a benchmark configuration's model (meta)."""
    cfg = ColvoConfig()
    overrides = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.apply_overrides([f"{k}={json.dumps(v)}" for k, v in overrides["overrides"].items()])
    with torch.device("meta"):
        model = ColVOModel(cfg.model)
    return [p.numel() for p in model.parameters()]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """A as built for the card, and with the blocks and threads reversed."""
    d, cxx = workdir(tmp_path_factory, "adam_emu", {"cuda_runtime.h": SHIM, "cuda_bf16.h": BF16})
    return tuple(adam.bind(compile_source(d, cxx, "adam", *flags))
                 for flags in ((), ("-DSHIM_REVERSE",)))


class Table:
    """A list's table built by ``lib``'s table kernel on host memory."""

    def __init__(self, lib, arrays):
        self.n, self.n_chunks, launches = adam.batches(arrays)
        self.grid = lib.colvo_adam_grid(self.n_chunks)
        self.words = torch.full((lib.colvo_adam_table_words(self.n, self.n_chunks),), -7,
                                dtype=torch.int64)
        for b in launches:
            assert lib.colvo_adam_table(self.words.data_ptr(), self.n, self.n_chunks, b,
                                        None) == 0

    def args(self):
        return self.words.data_ptr(), self.n, self.n_chunks, self.grid


def _tensors(sizes, seed, offsets=None, dtype=torch.float32, scale=1.0):
    """Tensors of ``sizes`` with normal values; with ``offsets`` each one a
    view into its own buffer that many elements in (misaligned)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        off = offsets[i % len(offsets)] if offsets else 0
        buf = torch.tensor(scale * rng.normal(size=n + off), dtype=torch.float32).to(dtype)
        out.append(buf[off:])
    return out


def test_constants_match_the_source(libs):
    lib = libs[0]
    assert lib.colvo_adam_chunk_quads() == adam.CHUNK_QUADS
    assert lib.colvo_adam_batch() == adam.BATCH
    assert ctypes.sizeof(adam.TableBatch) <= 4000  # a launch's arguments


@pytest.mark.parametrize("name", CONFIGS + ("mixed",))
def test_table_holds_each_chunks_first_tensor(libs, name):
    """The table of a training model's list (and one with empty and
    1-element tensors): the quad offsets, sizes and addresses as given,
    each chunk's first tensor the one that holds its first quad (the last
    of equal offsets: an empty tensor holds none), first[n_chunks] the last
    tensor, the tickets zero; and every tensor a chunk overlaps lies
    between its first tensor and the next chunk's, so the walk's search
    finds every quad's tensor."""
    numels = ([0, 1, 5, 0, 4, 3, 4096 * 3 + 1, 0, 1, 0] if name == "mixed"
              else _model_numels(name))
    gs = [torch.empty(n, device="meta") for n in numels]
    t = Table(libs[0], (None, gs, None, None, None))
    n, nc = t.n, t.n_chunks
    w = t.words.numpy()
    qoff_want, _ = adam.layout(numels)
    qoff = w[1:n + 2]
    assert w[0] == 0 and list(qoff) == qoff_want
    assert list(w[n + 2:2 * n + 2]) == numels
    assert (w[2 * n + 2:7 * n + 2] == 0).all()  # meta tensors' addresses
    first = w[7 * n + 2:7 * n + 2 + nc + 1]
    starts = np.arange(nc, dtype=np.int64) * adam.CHUNK_QUADS
    want = np.searchsorted(qoff, starts, side="right") - 1
    np.testing.assert_array_equal(first[:nc], want)
    assert first[nc] == n - 1
    q = np.asarray(qoff)
    for c in range(nc):
        lo, hi = c * adam.CHUNK_QUADS, (c + 1) * adam.CHUNK_QUADS
        over = np.nonzero((q[:-1] < hi) & (q[1:] > lo))[0]
        assert first[c] <= over.min() and over.max() <= first[c + 1]


def _plain(*args):
    """``adam.step_plain`` with a correctly rounded square root."""
    with mock.patch.object(torch, "_foreach_sqrt",
                           lambda ts: [t.double().sqrt().float() for t in ts]):
        adam.step_plain(*args)


def _run_step(lib, ps, gs, ms, vs, steps, lr, wd, bf16):
    t = Table(lib, (ps, gs, ms, vs, steps))
    a = adam.step_args(lr, (0.9, 0.999), 1e-8, wd, ms[0].dtype)
    assert lib.colvo_adam_step(*t.args(), a, int(bf16), None) == 0


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_step_equals_the_plain_chain_bit_for_bit(libs, mu_dtype, weight_decay):
    """Three A/steps against ``step_plain`` on copies: p, μ, ν and every
    step count bit for bit after steps 1 and 3, on a list that mixes sizes,
    with some tensors misaligned (views 1-3 elements into their buffer: the
    element-wise path) and the learning rate as a tensor; the reversed
    build gives the same bits."""
    bf16 = mu_dtype == torch.bfloat16
    ps0 = _tensors(SIZES, 1, offsets=(0, 1, 0, 2, 0, 3))
    lr = torch.tensor(2e-3)
    results = []
    for lib in libs:
        ps = [p.clone() for p in ps0]
        ms = [torch.zeros_like(p, dtype=mu_dtype) for p in ps]
        vs = _tensors(SIZES, 5, offsets=(0, 0, 1), scale=0.0)
        steps = [torch.zeros(()) for _ in ps]
        ref = [p.clone() for p in ps0]
        rm = [torch.zeros_like(p, dtype=mu_dtype) for p in ps]
        rv = [torch.zeros_like(p) for p in ps]
        rs = [torch.zeros(()) for _ in ps]
        for k in range(3):
            gs = _tensors(SIZES, 10 + k, offsets=(0, 0, 0, 1))
            _run_step(lib, ps, gs, ms, vs, steps, lr, weight_decay, bf16)
            _plain(ref, gs, rm, rv, rs, lr, (0.9, 0.999), 1e-8, weight_decay)
            if k in (0, 2):
                for got, want in ((ps, ref), (ms, rm), (vs, rv), (steps, rs)):
                    for i, (x, y) in enumerate(zip(got, want)):
                        assert x.dtype == y.dtype and torch.equal(x, y), (k, i, SIZES[i])
        results.append([x.clone() for x in ps + ms + vs])
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_step_with_a_float_learning_rate_and_its_counts(libs):
    """A float learning rate (refinement's) gives the chain's bits too, and
    a second call on the same table increments every step count again (the
    last CTA's ticket was reset)."""
    lib = libs[0]
    ps = _tensors(SIZES, 2)
    gs = _tensors(SIZES, 3)
    ms, vs = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
    steps = [torch.full((), 4.0) for _ in ps]
    ref, rm, rv = [p.clone() for p in ps], [torch.zeros_like(p) for p in ps], [
        torch.zeros_like(p) for p in ps]
    rs = [torch.full((), 4.0) for _ in ps]
    t = Table(lib, (ps, gs, ms, vs, steps))
    a = adam.step_args(1e-3, (0.9, 0.999), 1e-8, 0.0, torch.float32)
    for _ in range(2):
        assert lib.colvo_adam_step(*t.args(), a, 0, None) == 0
        _plain(ref, gs, rm, rv, rs, 1e-3, (0.9, 0.999), 1e-8, 0.0)
    assert all(float(s) == 6.0 for s in steps)
    for got, want in ((ps, ref), (ms, rm), (vs, rv)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def _sumsq(lib, gs, max_norm):
    t = Table(lib, (None, gs, None, None, None))
    partial = torch.full((t.grid,), float("nan"), dtype=torch.float64)
    out = torch.full((2,), float("nan"))
    assert lib.colvo_adam_sumsq(*t.args(), partial.data_ptr(), out.data_ptr(),
                                float(np.float32(max_norm)), None) == 0
    assert lib.colvo_adam_clip(*t.args(), out.data_ptr(), None) == 0
    return out


def test_sumsq_is_float64s_norm_and_the_same_bits_every_order(libs):
    """A/sumsq's norm within 1e-6 of the float64 norm over a list of many
    chunks and misaligned tensors, the same bits from both builds and from
    a second call (the ticket reset); clipping engaged, every element is
    scaled by the written scale exactly once."""
    gs0 = _tensors(SIZES, 4, offsets=(0, 3, 0, 1, 2))
    want = float(sum((g.double() ** 2).sum() for g in gs0)) ** 0.5
    outs = []
    for lib in libs + libs[:1]:
        gs = [g.clone() for g in gs0]
        out = _sumsq(lib, gs, 1.0)
        assert abs(float(out[0]) - want) <= 1e-6 * want
        scale = np.float32(1.0) / np.float32(out[0]) * np.float32(1.0)
        assert float(out[1]) == float(scale)
        for g, g0 in zip(gs, gs0):
            assert torch.equal(g, g0 * out[1])
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_clip_at_scale_one_leaves_the_bits(libs):
    """Below the limit the scale is 1 and A/clip writes nothing: signed
    zeros, subnormals and every other value keep their bits."""
    gs = _tensors(SIZES, 6, offsets=(0, 1), scale=1e-3)
    gs[0][0], gs[3][2], gs[6][5] = -0.0, 1e-45, -3e-39
    before = [g.clone().view(torch.int32) for g in gs]
    out = _sumsq(libs[0], gs, 1e6)
    assert float(out[1]) == 1.0
    assert all(torch.equal(g.view(torch.int32), b) for g, b in zip(gs, before))
