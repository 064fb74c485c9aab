"""Host-side native code through ``ctypes``: ``voxel.cpp`` (voxel
downsampling and pose chaining, a copy of ``colvo/native``) and
``png.cpp`` (PNG scanline unfiltering).

Both sources are compiled into one library with ``g++`` on first use into ``_build/``
(git-ignored), named by a hash of the sources, the flags and the host CPU's
target (``-march=native`` fits the binary to the CPU that built it), so a
changed source, or a checkout that moved to another host, rebuilds. There
is no fallback: a failed build or load raises.
The numpy plain versions live beside their callers and serve the tests
only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / f for f in ("voxel.cpp", "png.cpp"))
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# StreamingVO's fetch threads and the caller may both reach the first use.
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _cpu_identity() -> bytes:
    """What ``-march=native`` resolves to on this host: the compiler's
    list of target options with their values."""
    try:
        proc = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                              capture_output=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"cannot ask {CXX!r} for the host CPU's target: {e}") from e
    return proc.stdout


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_identity())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def _names() -> str:
    return " ".join(src.name for src in SOURCES)


def _build(out: Path) -> None:
    """Compile into a temporary file and move it in place, so a process
    never loads another's half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, *map(str, SOURCES), "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run {CXX!r} to build {_names()}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed to build {_names()}:\n{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.voxel_downsample.restype = ctypes.c_int64
        lib.voxel_downsample.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_float,
                                         _F32P, _F32P]
        lib.chain_poses.restype = None
        lib.chain_poses.argtypes = [_F64P, ctypes.c_int64, ctypes.c_int64, _F64P]
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                     _U8P]
        _lib = lib
        return lib


def voxel_downsample(
    points: np.ndarray, voxel: float, colors: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and colors) within voxel cells in one hash-table
    pass; cells come out in order of first appearance."""
    lib = library()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    if not voxel > 0:
        raise ValueError(f"voxel must be > 0, got {voxel}")
    out_p = np.empty_like(pts)
    cols = out_c = None
    if colors is not None:
        cols = np.ascontiguousarray(colors, dtype=np.float32)
        if cols.shape != pts.shape:
            raise ValueError(f"colors {cols.shape} must match points {pts.shape}")
        out_c = np.empty_like(cols)
    ptr = lambda a: None if a is None else a.ctypes.data_as(_F32P)  # noqa: E731
    m = lib.voxel_downsample(ptr(pts), ptr(cols), len(pts), voxel, ptr(out_p), ptr(out_c))
    return out_p[:m].copy(), (out_c[:m].copy() if out_c is not None else None)


def chain_poses(rels: np.ndarray, renorm_every: int = 50) -> np.ndarray:
    """Chain (N, 4, 4) relative target→source transforms into (N+1, 4, 4)
    cam→world poses (float64; Gram–Schmidt renormalization of the rotation
    every ``renorm_every`` steps, never when it is ≤ 0)."""
    lib = library()
    rels = np.ascontiguousarray(rels, dtype=np.float64)
    if rels.ndim != 3 or rels.shape[1:] != (4, 4):
        raise ValueError(f"rels must be (N, 4, 4), got {rels.shape}")
    out = np.empty((len(rels) + 1, 4, 4), dtype=np.float64)
    lib.chain_poses(rels.ctypes.data_as(_F64P), len(rels), renorm_every,
                    out.ctypes.data_as(_F64P))
    return out


def png_unfilter(data: bytes, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of inflated PNG image data: ``rows``
    scanlines of a filter-type byte and ``stride`` bytes each, ``bpp``
    bytes a pixel. Returns the raw (rows, stride) uint8 pixels."""
    lib = library()
    buf = np.frombuffer(data, dtype=np.uint8)
    if rows < 0 or stride < 0 or bpp < 1 or buf.size != rows * (stride + 1):
        raise ValueError(f"{buf.size} bytes of image data for {rows} rows of {stride} bytes "
                         f"(+1 filter byte each) at {bpp} bytes a pixel")
    out = np.empty((rows, stride), dtype=np.uint8)
    bad = lib.png_unfilter(buf.ctypes.data_as(_U8P), rows, stride, bpp, out.ctypes.data_as(_U8P))
    if bad:
        raise ValueError(f"row {bad - 1}: PNG filter type {buf[(bad - 1) * (stride + 1)]} "
                         "is not 0-4")
    return out
