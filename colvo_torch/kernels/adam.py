"""A: the training step's update, the global-norm clip and Adam, over the
list of one parameter group's tensors (``csrc/adam.cu``).

``clip_global_norm`` and ``adam_update`` choose by the tensors' device:
CUDA tensors take kernel A, one launch a pass over the whole list
(``A/sumsq`` then ``A/clip``; ``A/step``), CPU tensors the plain chain of
``torch._foreach_*`` passes (``clip_plain``, ``step_plain``). Other
devices raise. Each launch counts as ``A/sumsq``, ``A/clip`` or
``A/step`` (``kernels.launch_counts``); the table builds do not count.

The function is optax's ``clip_by_global_norm`` and ``scale_by_adam`` (with
``add_decayed_weights``) in the order of operations of ``step_plain``,
which A/step follows bit for bit; A/sumsq sums in float64 (the norm within
1e-6 of float64's, the same bits on every call).

Each list has a table on the device (``Plan``): the tensors' addresses and
sizes and how the launch's chunks fall on them. The optimizer keeps the
tables of its lists (``Plans``, outside its state), keyed by each
tensor's address, device, dtype, shape and strides, so a table is
rebuilt only when a tensor moves (the gradients of eager steps may); a
table a CUDA graph captured lives as long as the optimizer. The clip
takes no optimizer: it reads the table of the step that holds its
gradients where one is held (``_BY_GRADS``, which keeps none alive), and
builds a table of its own for the call where none is. The build is
itself launches, whose arguments carry the addresses, so a capture (the
refinement's, whose optimizer is made and dropped inside it) may build a
table too: each replay rebuilds it.

Layout: p, g, ν float32, μ float32 or bfloat16, each tensor dense, the four
of one parameter with one shape and the same strides; the step counts
float32 scalars and the learning rate a float or a float32 scalar, on the
tensors' device.
"""

from __future__ import annotations

import ctypes
import weakref
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch

from colvo_torch.kernels import build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

BATCH = 64   # kBatch of csrc/adam.cu: tensors a table launch writes
NAMES = ("params", "grads", "mus", "nus", "steps")  # a list's arrays, in the table's order
ARRAYS = len(NAMES)
G, MU, STEP = 1, 2, 4
CHUNK_QUADS = 1024  # kChunkQuads


class TableBatch(ctypes.Structure):
    """``TableBatch`` of ``csrc/adam.cu``, field for field."""
    _fields_ = [("qoff", _L * (BATCH + 1)), ("numel", _L * BATCH),
                ("ptr", (_L * BATCH) * ARRAYS), ("lo", _I), ("count", _I)]


class StepArgs(ctypes.Structure):
    """``StepArgs`` of ``csrc/adam.cu``, field for field."""
    _fields_ = [("lr", _P), ("lr_value", _F), ("b1", _F), ("b2", _F), ("b1_mu", _F),
                ("c1", _F), ("c2", _F), ("eps", _F), ("wd", _F)]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of ``csrc/adam.cu``'s entry
    points on a library built from it."""
    if lib.colvo_adam_step.argtypes is None:
        lib.colvo_adam_table_words.argtypes = [_I, _L]
        lib.colvo_adam_table_words.restype = _L
        lib.colvo_adam_chunk_quads.restype = _L
        lib.colvo_adam_batch.restype = _I
        lib.colvo_adam_grid.argtypes = [_L]
        lib.colvo_adam_grid.restype = _I
        lib.colvo_adam_table.argtypes = [_P, _I, _L, TableBatch, _P]
        lib.colvo_adam_sumsq.argtypes = [_P, _I, _L, _I, _P, _P, _F, _P]
        lib.colvo_adam_clip.argtypes = [_P, _I, _L, _I, _P, _P]
        lib.colvo_adam_step.argtypes = [_P, _I, _L, _I, StepArgs, _I, _P]
        for fn in (lib.colvo_adam_table, lib.colvo_adam_sumsq, lib.colvo_adam_clip,
                   lib.colvo_adam_step):
            fn.restype = _I
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.library("adam"))


# ------------------------------------------------------------ the plain chain

def clip_plain(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Plain version: optax ``clip_by_global_norm``, scaling by
    max_norm/‖g‖ only when ‖g‖ ≥ max_norm (no +1e-6 in the divisor), in
    place. Returns ‖g‖ before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def step_plain(params: List[torch.Tensor], grads: List[torch.Tensor],
               mus: List[torch.Tensor], nus: List[torch.Tensor], steps: List[torch.Tensor],
               lr, betas: Tuple[float, float], eps: float, weight_decay: float) -> None:
    """Plain version: one Adam step in optax's order of operations (see
    ``runtime.optim``), in place: a few ``torch._foreach_*`` passes over all
    tensors. The step counts of one list move together."""
    b1, b2 = betas
    mu_dtype = mus[0].dtype
    torch._foreach_add_(steps, 1.0)
    mu = torch._foreach_mul(grads, 1.0 - b1)
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
    torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_mu)])
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    # the bias corrections, f32 as optax computes them
    t = steps[0].to(params[0].device)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    if weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(upd, -lr if not isinstance(lr, torch.Tensor) else torch.neg(lr))
    torch._foreach_add_(params, upd)
    torch._foreach_copy_(mus, mu)  # rounded to nearest even


# ------------------------------------------------------------------ the table

def layout(numels: Sequence[int]) -> Tuple[List[int], int]:
    """The flat quad space of a list: each tensor's first quad (a tensor
    takes ceil(numel / 4) quads), the quad after the last, and the number
    of chunks of ``CHUNK_QUADS`` quads that cover it."""
    qoff = [0]
    for n in numels:
        qoff.append(qoff[-1] + (int(n) + 3) // 4)
    return qoff, -(-qoff[-1] // CHUNK_QUADS)


def batches(arrays: Sequence[Optional[Sequence[torch.Tensor]]]
            ) -> Tuple[int, int, List[TableBatch]]:
    """A list's table: its tensor count, its chunk count and the arguments
    of each launch that writes it (``BATCH`` tensors at most a launch).
    ``arrays`` holds, per array of the layout (p, g, μ, ν, step), its
    tensors in the list's order, or None where the list has no such array
    (the clip's list has only g)."""
    ref = next(a for a in arrays if a is not None)
    qoff, n_chunks = layout([t.numel() for t in ref])
    out = []
    for lo in range(0, len(ref), BATCH):
        hi = min(lo + BATCH, len(ref))
        b = TableBatch(lo=lo, count=hi - lo)
        b.qoff[:hi - lo + 1] = qoff[lo:hi + 1]
        b.numel[:hi - lo] = [t.numel() for t in ref[lo:hi]]
        for a, ts in enumerate(arrays):
            if ts is not None:
                b.ptr[a][:hi - lo] = [t.data_ptr() for t in ts[lo:hi]]
        out.append(b)
    return len(ref), n_chunks, out


class Plan:
    """One tensor list's table on the device (``batches``) and the grid of
    A's launches; the list is checked first (``check``). ``captured``: a
    CUDA graph's launches read the table."""

    def __init__(self, arrays: Sequence[Optional[Sequence[torch.Tensor]]],
                 device: torch.device):
        check(arrays)
        lib = _lib()
        self.captured = False
        self.n, self.n_chunks, launches = batches(arrays)
        self.grid = lib.colvo_adam_grid(self.n_chunks)
        if self.grid < 0:
            raise RuntimeError("adam kernel: cannot read the device's SM count")
        self.table = build.empty(lib.colvo_adam_table_words(self.n, self.n_chunks),
                                 torch.int64, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        for b in launches:
            with torch.cuda.device(device):
                err = lib.colvo_adam_table(self.table.data_ptr(), self.n, self.n_chunks, b,
                                           stream)
            if err != 0:
                raise RuntimeError(f"adam table launch failed (cudaError {err})")

    def args(self) -> tuple:
        return self.table.data_ptr(), self.n, self.n_chunks, self.grid

    def use(self) -> "Plan":
        """The plan, marked ``captured`` where a CUDA graph is being
        captured (its replays read the table)."""
        if torch.cuda.is_current_stream_capturing():
            self.captured = True
        return self


def _key(ts: Sequence[torch.Tensor]) -> tuple:
    """What a list's table and its check depend on: each tensor's address,
    device, dtype, shape and strides."""
    return tuple((t.data_ptr(), t.device, t.dtype, t.shape, t.stride()) for t in ts)


# The tables ``Plans`` hold, by their gradients' ``_key``, for the clip
# (weak: a table lives as long as the ``Plans`` that holds it).
_BY_GRADS: "weakref.WeakValueDictionary[tuple, Plan]" = weakref.WeakValueDictionary()


class Plans:
    """The tables of the tensor lists one optimizer updates, keyed by the
    lists' ``_key``: the ``RECENT`` used last, and every one a CUDA graph
    captured, for the owner's life. A list is checked when its table is
    built; a list of the same key is the checked one's layout at its
    addresses, and is served by its table. A table built inside a capture
    is not kept: its launches are the graph's, and each replay builds it
    again."""

    RECENT = 4

    def __init__(self):
        self._plans: "OrderedDict[tuple, Plan]" = OrderedDict()

    def get(self, arrays: Sequence[Optional[Sequence[torch.Tensor]]],
            device: torch.device) -> Plan:
        key = tuple(None if ts is None else _key(ts) for ts in arrays)
        plan = self._plans.pop(key, None)
        if plan is None:
            plan = Plan(arrays, device)
            if torch.cuda.is_current_stream_capturing():
                return plan
        self._plans[key] = plan.use()
        for old in [k for k, p in self._plans.items() if not p.captured][:-self.RECENT]:
            del self._plans[old]
        _BY_GRADS[key[G]] = plan
        return plan


def _dense(t: torch.Tensor) -> bool:
    if t.is_contiguous():
        return True
    step = 1
    for stride, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n != 1):
        if stride != step:
            return False
        step *= n
    return True


def check(arrays: Sequence[Optional[Sequence[torch.Tensor]]]) -> torch.device:
    """The device of a list's arrays (p, g, μ, ν, step; None where absent).
    Raises unless the element arrays' tensors lie on one device, are
    dense, and have the shape and strides of the first array's tensor at
    their place; on a card also unless p, g, ν are float32, μ float32 or
    bfloat16 throughout, and the step counts float32 scalars there. Other
    devices than the CPU and CUDA raise."""
    elems = [ts for ts in arrays[:STEP] if ts is not None]
    ref = elems[0]
    if not ref:
        raise ValueError("adam kernel takes a list of at least one tensor")
    device = ref[0].device
    for ts in elems:
        if len(ts) != len(ref):
            raise ValueError(f"adam kernel takes lists of one length, got {len(ts)} and "
                             f"{len(ref)}")
        for t, r in zip(ts, ref):
            if t.device != device:
                raise ValueError(f"adam kernel takes tensors on one device, got {t.device} "
                                 f"and {device}")
            if not _dense(t):
                raise ValueError(f"adam kernel takes dense tensors, got strides {t.stride()} "
                                 f"at {tuple(t.shape)}")
            if t.shape != r.shape or any(a != b for a, b, n in zip(t.stride(), r.stride(),
                                                                    t.shape) if n != 1):
                raise ValueError(f"adam kernel takes tensors of one shape and strides, got "
                                 f"{tuple(t.shape)} {t.stride()} and {tuple(r.shape)} "
                                 f"{r.stride()}")
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"adam kernel needs CUDA tensors, got {device}")
    for a, ts in enumerate(arrays):
        if ts is None:
            continue
        allowed = (torch.float32, torch.bfloat16) if a == MU else (torch.float32,)
        dtypes = {t.dtype for t in ts}
        if not dtypes <= set(allowed) or len(dtypes) > 1:
            raise TypeError(f"adam kernel takes {NAMES[a]} of one dtype of {allowed}, got "
                            f"{sorted(map(str, dtypes))}")
    if arrays[STEP] is not None and (len(arrays[STEP]) != len(ref) or any(
            s.device != device or s.numel() != 1 for s in arrays[STEP])):
        raise ValueError(f"adam kernel reads the step counts as scalars on {device}")
    return device


def _f32(x: float) -> float:
    """x rounded to float32, as PyTorch casts a Python scalar."""
    return float(torch.tensor(x, dtype=torch.float32))


def step_args(lr, betas: Tuple[float, float], eps: float, weight_decay: float,
              mu_dtype: torch.dtype) -> StepArgs:
    """A/step's constants, each rounded as ``step_plain`` rounds it; a
    tensor ``lr`` is read where it lies."""
    b1, b2 = betas
    lr_t = lr if isinstance(lr, torch.Tensor) else None
    return StepArgs(lr=lr_t.data_ptr() if lr_t is not None else None,
                    lr_value=0.0 if lr_t is not None else _f32(lr), b1=_f32(b1), b2=_f32(b2),
                    b1_mu=float(torch.tensor(b1, dtype=mu_dtype)), c1=_f32(1.0 - b1),
                    c2=_f32(1.0 - b2), eps=_f32(eps), wd=_f32(weight_decay))


# ------------------------------------------------------------------ the passes

def clip_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` of ``grads`` in place: scaled by
    max_norm/‖g‖ only when ‖g‖ ≥ max_norm. Returns ‖g‖ before clipping, a
    float32 scalar on their device. CUDA tensors: A/sumsq then A/clip (on
    the table of the optimizer step that holds these gradients, else on
    one built for the call); CPU tensors: ``clip_plain``."""
    arrays = (None, list(grads), None, None, None)
    if not arrays[1]:
        raise ValueError("adam kernel takes a list of at least one tensor")
    device = arrays[1][0].device
    if device.type != "cuda":
        check(arrays)  # a CPU list, or raises
        return clip_plain(arrays[1], max_norm)
    plan = _BY_GRADS.get(_key(arrays[1]))
    plan = plan.use() if plan is not None else Plan(arrays, device)
    partial = build.empty(plan.grid, torch.float64, device)
    out = build.empty(2, torch.float32, device)
    lib, stream = _lib(), torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.colvo_adam_sumsq(*plan.args(), partial.data_ptr(), out.data_ptr(),
                                   _f32(max_norm), stream)
        if err == 0:
            build.count_launch("A/sumsq")
            err = lib.colvo_adam_clip(*plan.args(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"adam clip launch failed (cudaError {err})")
    build.count_launch("A/clip")
    return out[0]


def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                mus: List[torch.Tensor], nus: List[torch.Tensor], steps: List[torch.Tensor],
                lr, betas: Tuple[float, float], eps: float, weight_decay: float, *,
                plans: Plans) -> None:
    """One Adam step over a parameter group, in place: the parameters, the
    moments μ (``exp_avg``) and ν (``exp_avg_sq``) and the step counts.
    CUDA tensors: one A/step launch (its table in the caller's ``plans``;
    the step counts and a tensor ``lr`` on the same device, so that nothing
    is read on the host); CPU tensors: ``step_plain``."""
    arrays = (params, grads, mus, nus, steps)
    if not params:
        raise ValueError("adam kernel takes a list of at least one tensor")
    device = params[0].device
    if device.type != "cuda":
        check(arrays)  # a CPU list, or raises
        return step_plain(params, grads, mus, nus, steps, lr, betas, eps, weight_decay)
    if isinstance(lr, torch.Tensor) and (lr.device != device or lr.dtype != torch.float32
                                         or lr.numel() != 1):
        raise ValueError(f"adam kernel reads a tensor learning rate as a float32 scalar on "
                         f"{device}, got {lr.dtype} on {lr.device}")
    plan = plans.get(arrays, device)
    a = step_args(lr, betas, eps, weight_decay, mus[0].dtype)
    with torch.cuda.device(device):
        err = _lib().colvo_adam_step(*plan.args(), a, int(mus[0].dtype == torch.bfloat16),
                                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam step launch failed (cudaError {err})")
    build.count_launch("A/step")
