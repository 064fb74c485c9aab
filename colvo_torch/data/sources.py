"""Frame sources (port of ``colvo/data/sources.py``).

Read frame directories or decode video into fixed-resolution frames on the
host. PNG frames go through the port's own codec (``data/png.py``), the
resize is an area resize in numpy equal to ``cv2.resize(INTER_AREA)``
within 1 LSB, and I420 packing equals ``cv2.COLOR_RGB2YUV_I420``: the
card's host has no cv2. cv2 is imported only where a JPEG or BMP file or a
video is read, and its absence there raises an ``ImportError`` naming the
file.

``pixel_format``: ``"float"`` (float32 RGB in [0, 1]), ``"rgb8"`` (uint8
RGB; the streaming VO executor normalises on the device) or ``"i420"``
(planar uint8 YUV 4:2:0, limited-range BT.601, (H·3/2, W); pair with
``run_vo(input_format="i420")``).
"""

from __future__ import annotations

import math
import os
from typing import Iterator, List, Tuple

import numpy as np

from colvo_torch.data.png import read_png

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")

# cv2's RGB → YUV 4:2:0 coefficients (BT.601 limited range, 20-bit fixed
# point): Y from every pixel, U and V from the top-left pixel of each 2×2
# block, as ``cv2.COLOR_RGB2YUV_I420`` computes them.
_SHIFT = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448  # and CRV = CBU


def _cv2(path: str):
    """cv2, for the files that only it reads here (JPEG, BMP, video)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs cv2 (opencv-python); only PNG frames are "
                          "read without it") from e
    return cv2


def _read_rgb8(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, as ``cv2.imread(IMREAD_COLOR)``
    and BGR→RGB give it."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.dtype == np.uint16:  # 16-bit gray: IMREAD_COLOR keeps the high byte
            img = np.repeat((img >> 8).astype(np.uint8)[..., None], 3, axis=-1)
        return img
    cv2 = _cv2(path)
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"unreadable image {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def rgb_to_i420_cv2(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB → (H·3/2, W) planar I420, equal to
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)``: chroma of each 2×2 block
    from its top-left pixel (``vo/stream.py::rgb_to_i420`` averages the
    block instead, as the reference's stream helper does)."""
    h, w, _ = rgb.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs an even height and width, not {h}x{w}")
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    half = 1 << (_SHIFT - 1)
    y = (_CRY * r + _CGY * g + _CBY * b + half + (16 << _SHIFT)) >> _SHIFT
    r, g, b = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = (_CRU * r + _CGU * g + _CBU * b + half + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * r + _CGV * g + _CBV * b + half + (128 << _SHIFT)) >> _SHIFT
    planes = [np.clip(p, 0, 255).astype(np.uint8).reshape(-1) for p in (y, u, v)]
    return np.concatenate(planes).reshape(h * 3 // 2, w)


def _emit(rgb_resized: np.ndarray, pixel_format: str) -> np.ndarray:
    if pixel_format == "float":
        return _to_float_rgb(rgb_resized)
    if pixel_format == "rgb8":
        return rgb_resized
    if pixel_format == "i420":
        return rgb_to_i420_cv2(rgb_resized)
    raise ValueError(f"unknown pixel_format {pixel_format!r}")


def _taps(rows: List[List[Tuple[int, float]]]) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged (index, weight) lists → (n, K) indices and weights, zero-padded."""
    k = max(len(t) for t in rows)
    idx = np.zeros((len(rows), k), np.int64)
    wts = np.zeros((len(rows), k), np.float32)
    for i, taps in enumerate(rows):
        for j, (s, wt) in enumerate(taps):
            idx[i, j], wts[i, j] = s, wt
    return idx, wts


def _area_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's ``INTER_AREA`` weights along one axis where the image shrinks
    or keeps its size: each output cell averages the source cells it
    covers, partly covered ones by their fraction."""
    scale = src / dst
    rows = []
    for dx in range(dst):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(f2 - s2, 1.0, cell) / cell))
        rows.append(taps)
    return _taps(rows)


def _linear_area_taps(src: int, dst: int, fixed_point: bool) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's ``INTER_AREA`` weights along one axis where an axis of the
    image grows: linear between two neighbours, the weight snapping to the
    nearer one, rounded to 11-bit fixed point for uint8 (``fixed_point``)."""
    scale, inv = src / dst, dst / src
    rows = []
    for dx in range(dst):
        sx = math.floor(dx * scale)
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        w0, w1 = 1.0 - fx, fx
        if fixed_point:
            w0, w1 = round(w0 * 2048) / 2048, round(w1 * 2048) / 2048
        rows.append([(sx, w0), (min(sx + 1, src - 1), w1)])
    return _taps(rows)


def _resize(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(frame, (width, height), interpolation=INTER_AREA)``
    within 1 LSB for uint8: separable banded weights, rows then columns,
    in float32; uint8 results rounded half up. Float frames stay float32.
    cv2 averages cells where neither axis grows and interpolates otherwise."""
    h, w = frame.shape[:2]
    if h == height and w == width:
        return frame
    if height <= h and width <= w:
        (iy, wy), (ix, wx) = _area_taps(h, height), _area_taps(w, width)
    else:
        fixed = frame.dtype == np.uint8
        (iy, wy), (ix, wx) = (_linear_area_taps(h, height, fixed),
                              _linear_area_taps(w, width, fixed))
    out = frame.reshape(h, w, -1).astype(np.float32)
    out = sum(wy[:, j, None, None] * out[iy[:, j]] for j in range(iy.shape[1]))
    out = sum(wx[None, :, j, None] * out[:, ix[:, j]] for j in range(ix.shape[1]))
    out = out.reshape(height, width, *frame.shape[2:])
    if frame.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def _to_float_rgb(frame: np.ndarray) -> np.ndarray:
    if frame.dtype == np.uint8:
        frame = frame.astype(np.float32) / 255.0
    return frame.astype(np.float32)


class FrameDirSource:
    """Reads a directory of image files (sorted lexicographically)."""

    def __init__(self, path: str, width: int, height: int,
                 pixel_format: str = "float"):
        self.path = path
        self.width = width
        self.height = height
        self.pixel_format = pixel_format
        self.files: List[str] = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith(_IMG_EXTS)
        )
        if not self.files:
            raise FileNotFoundError(f"no image files under {path}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        rgb = _read_rgb8(self.files[idx])
        return _emit(_resize(rgb, self.width, self.height), self.pixel_format)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


class VideoFrameSource:
    """Decodes a video file into frames at fixed resolution (cv2).

    Streaming: holds only the decoder open, O(1) memory.
    """

    def __init__(self, path: str, width: int, height: int, stride: int = 1,
                 pixel_format: str = "float"):
        cv2 = _cv2(path)
        self.path = path
        self.width = width
        self.height = height
        self.stride = stride
        self.pixel_format = pixel_format
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {path}")
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        # ceil: iteration yields indices 0, stride, 2*stride, … < count
        self._n = (count + stride - 1) // stride
        cap.release()

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[np.ndarray]:
        cv2 = _cv2(self.path)
        cap = cv2.VideoCapture(self.path)
        idx = 0
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    return
                if idx % self.stride == 0:
                    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                    yield _emit(_resize(rgb, self.width, self.height),
                                self.pixel_format)
                idx += 1
        finally:
            cap.release()


class ArraySource:
    """Wraps an in-memory (N, H, W, 3) array (synthetic sequences, tests)."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.frames[idx]

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.frames)


def open_source(path_or_array, width: int, height: int, stride: int = 1,
                pixel_format: str = "float"):
    """Open a frame source from a path (dir or video file) or array."""
    if isinstance(path_or_array, np.ndarray):
        return ArraySource(path_or_array)
    if os.path.isdir(path_or_array):
        return FrameDirSource(path_or_array, width, height,
                              pixel_format=pixel_format)
    return VideoFrameSource(path_or_array, width, height, stride,
                            pixel_format=pixel_format)
