"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes``; the build is
cached under ``_build/`` (git-ignored) by a hash of the sources and flags,
so the first use on a machine builds and later uses load. ``ptxas``'s
report of each kernel's registers and spills is kept beside the library. Nothing here
runs at import time: this module is imported on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("sampler", "scatter", "fused_loss", "project", "lcc", "ssim", "factor_attention",
           "adam")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# The launch counters' prefix among the counters of ``runtime.spans``.
LAUNCH = "launch."


def count_launch(key: str) -> None:
    """One launch of a CUDA kernel, keyed as ``kernels.launch_counts`` gives
    it (``S/grad/C3``), into the launch counters."""
    from colvo_torch.runtime import spans  # the runtime package imports the kernels

    spans.tally(LAUNCH + key)


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on ``ts`` (the wrappers' Functions)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def empty(numel: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A new (numel,) tensor, left unfilled also under deterministic
    algorithms (which fill ``torch.empty``'s memory): for buffers a kernel
    writes or zeroes whole, where a fill would be a wasted pass over it."""
    storage = torch.UntypedStorage(numel * dtype.itemsize, device=device)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, (numel,), (1,))


def like(x: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """An unfilled tensor of ``shape`` and x's dtype and device: in x's
    layout where x is dense with that shape (a permuted plane stack stays
    one), else contiguous."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    dense, step = x.shape == shape, 1
    for d in reversed(order):
        dense = dense and (x.shape[d] == 1 or x.stride(d) == step)
        step *= x.shape[d]
    if not dense:
        order = list(range(len(shape)))
    buf = empty(shape.numel(), x.dtype, x.device).view([shape[d] for d in order])
    return buf.permute([order.index(d) for d in range(len(shape))])


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh") and (p.stem == name or p.suffix == ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path):
    """Launch ``nvcc`` for one source into a temporary file beside ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    out.with_suffix(".ptxas").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    with _lock:
        procs = {n: _start(n, _target(n)) for n in names if not _target(n).exists()}
        errors = []
        for n, proc in procs.items():
            try:
                _finish(n, *proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """``ptxas -v``'s report from the build of ``csrc/<name>.cu``."""
    build_all([name])
    return _target(name).with_suffix(".ptxas").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name) or ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
