"""A PNG codec on the standard library, numpy and the port's native code:
the port's counterpart of the reference's ``cv2.imread`` /
``cv2.imwrite`` / ``imageio.imwrite`` for PNG files (the card's host has
neither library).

``zlib`` inflates; the per-row filters are undone in C++
(``colvo_torch/native/png.cpp``), since Sub, Average and Paeth run left to
right within a row. An Adam7-interlaced file holds seven sub-images one
after the other, each with its own filter bytes: each is undone on its own
and scattered into the frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from colvo_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel, by colour type: gray, RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _deinterlace(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Inflated Adam7 data → the raw (h, w·bpp) pixel bytes: each pass's
    sub-image unfiltered on its own (an empty pass has no bytes, not even
    filter bytes) and scattered to its pixels."""
    raw = np.empty((h, w, bpp), dtype=np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        n = ph * (pw * bpp + 1)
        sub = native.png_unfilter(data[pos:pos + n], ph, pw * bpp, bpp)
        raw[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
        pos += n
    if pos != len(data):
        raise ValueError(f"{len(data)} bytes of Adam7 data for {pos} bytes of passes")
    return raw.reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file of bit depth 8 or 16 and colour type 0, 2, 3, 4 or
    6 as ``cv2.imread`` does, in RGB order: (H, W, 3) uint8, alpha dropped,
    gray replicated, a palette looked up, 16-bit colour reduced to its high
    byte; 16-bit gray comes back as (H, W) uint16, as
    ``cv2.IMREAD_UNCHANGED`` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no image data")
    w, h, depth, ctype, _, _, interlace = header
    if interlace not in (0, 1):
        raise ValueError(f"{path}: interlace method {interlace}")
    if depth not in (8, 16) or ctype not in _CHANNELS or (ctype == 3 and depth != 8):
        raise NotImplementedError(f"{path}: bit depth {depth}, colour type {ctype}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    data = zlib.decompress(b"".join(idat))
    if interlace:
        px = _deinterlace(data, h, w, bpp)
    else:
        px = native.png_unfilter(data, h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").reshape(h, w, ch)
        if ctype == 0:
            return px[..., 0].astype(np.uint16)
        px = (px >> 8).astype(np.uint8)
    else:
        px = px.reshape(h, w, ch)
    if ctype == 3:
        if px.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index past the {len(palette)} entries")
        return palette[px[..., 0]]
    if ch <= 2:  # gray, gray+alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """Encode (H, W, 3) uint8 as 8-bit RGB, or (H, W) uint16 as 16-bit
    gray (filter type 0 on every row, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth, raw = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, raw = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write 8-bit RGB (H, W, 3) uint8 or 16-bit gray (H, W) uint16, "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(raw).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` to ``path`` as :func:`png_bytes` encodes it."""
    data = png_bytes(img)
    with open(path, "wb") as f:
        f.write(data)
