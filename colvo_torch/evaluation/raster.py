"""A small numpy rasterizer for the figures of ``evaluation/viz.py``: the
port's stand-in for matplotlib, which the card's host lacks.

A :class:`Figure` is a white canvas of the reference's size (inches × its
130 dpi) holding axes that record what is drawn and render it when the
figure is saved, as matplotlib does, so that limits may be set after the
data. :class:`Axes3D` projects orthographically at matplotlib's ``elev``
and ``azim`` into a box of aspect 4:4:3; :class:`ImageAxes` shows an image
resampled to fit (nearest), keeping its aspect; :class:`Axes2D` draws line
plots (solid or dashed, with circle or square markers) against linear axes
with ticks and a legend. Lines are anti-aliased by their coverage of each
pixel; points are splatted with their alpha; text uses a 6×11 bitmap font,
doubled for titles. Output goes through ``data/png.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from colvo_torch.data.png import write_png

DPI = 130  # the reference's savefig dpi
PT = DPI / 72.0  # pixels a point

# Printable ASCII (32-126) in a 6×11 cell, generated once from the bitmap
# font that Pillow carries (``ImageFont.load_default_imagefont()``): for
# each glyph 11 rows of 2 hex digits, the most significant of 6 bits the
# leftmost column. Other characters draw as "?", an em dash as a bar.
_FONT_HEX = (
    "0000000000000000000000 0000001818181800180000 0000001414140000000000 000014143e14143e141400 "
    "00081e323c1e06363c0800 0000382a3c081e2a0e0000 0000001c30183e2c3e0000 00000c0810000000000000 "
    "0000040818181818080400 000010080c0c0c0c081000 0000083c18240000000000 00000008083e0808000000 "
    "00000000000000000c0810 00000000003e0000000000 0000000000000000180000 0000020204040808101000 "
    "00001c36363636361c0000 00000c3c0c0c0c0c3f0000 00001c36060c18363e0000 00001c36061c06361c0000 "
    "0000060e16363f06060000 00003e303c3606263c0000 00001c36303c36361c0000 00003e36060c0c18180000 "
    "00001c36361c36361c0000 00001c36361e06361c0000 0000000000180000180000 0000000000180000181020 "
    "0000000c1830180c000000 000000003c003c00000000 000000180c060c18000000 0000001c260c1800180000 "
    "00001c32262a2a27301c00 0000003c1c143e36370000 0000003c363c36363c0000 0000001e363030361c0000 "
    "0000003c363636363c0000 0000003e303c30363e0000 0000003e303c3030380000 0000001c36303e361e0000 "
    "00000037363e3636370000 0000003c181818183c0000 0000001e0c0c2c2c380000 0000003634383c363b0000 "
    "00000038303030363e0000 0000002236363e2a2a0000 000000373a3a3636320000 0000001c363636361c0000 "
    "0000003c36363c30380000 0000001c363636361c0600 0000003c36363c363b0000 0000001e323c0e263c0000 "
    "0000003e1a1818183c0000 00000037363636361c0000 0000003736141c1c080000 0000002b2a2a3e1c140000 "
    "000000331e0c0c1e330000 00000033331e0c0c1e0000 0000003e360c18363e0000 00001c1818181818181c00 "
    "0000202010100808040400 00001c0c0c0c0c0c0c1c00 0000081c36000000000000 000000000000000000003f "
    "0000180804000000000000 000000001c361e363f0000 000030303c3636363c0000 000000001c3630361c0000 "
    "00000e061e3636361f0000 000000001c363e301e0000 00000e183e1818183e0000 000000001b3636361e063c "
    "000030303c363636360000 00000c003c0c0c0c3f0000 00000c003c0c0c0c0c0c38 00003030363c383c370000 "
    "00003c0c0c0c0c0c3f0000 000000003c3e2a2a2a0000 000000002c363636360000 000000001c3636361c0000 "
    "000000003c3636363c3038 000000001b3636361e060f 00000000371d18183c0000 000000001e381e073e0000 "
    "000018183e18181b0e0000 00000000363636361f0000 0000000036361c1c080000 000000002b2a3e1e140000 "
    "000000003b1e0c1e370000 00000000373636141c1830 000000003e2c18363e0000 0000060c0c180c0c0c0600 "
    "0000000808080808080800 00003018180c1818183000 000000001a2c0000000000 "
)
GLYPH_W, GLYPH_H = 6, 11
_BASELINE = 8  # the row under the glyphs' baseline
_GLYPHS = {
    chr(32 + i): np.array([[(int(g[2 * r:2 * r + 2], 16) >> (5 - c)) & 1 for c in range(GLYPH_W)]
                           for r in range(GLYPH_H)], dtype=bool)
    for i, g in enumerate(_FONT_HEX.split())
}
_GLYPHS["\u2014"] = np.zeros((GLYPH_H, GLYPH_W), bool)
_GLYPHS["\u2014"][5] = True

# matplotlib's named colours that the figures use, and its default cycle
NAMED = {
    "k": (0.0, 0.0, 0.0), "blue": (0.0, 0.0, 1.0), "lime": (0.0, 1.0, 0.0),
    "darkgreen": (0.0, 100 / 255, 0.0), "tan": (210 / 255, 180 / 255, 140 / 255),
    "lightgray": (211 / 255,) * 3,
}
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")


def rgb(color) -> np.ndarray:
    """A colour name, ``#rrggbb`` or RGB triple in [0, 1] → float32 (3,)."""
    if isinstance(color, str):
        if color.startswith("#"):
            return np.array([int(color[i:i + 2], 16) / 255 for i in (1, 3, 5)], np.float32)
        return np.array(NAMED[color], np.float32)
    return np.asarray(color, np.float32)


def text_size(s: str, scale: int = 1) -> Tuple[int, int]:
    """(width, height) in pixels of ``s`` in the bitmap font."""
    return len(s) * GLYPH_W * scale, GLYPH_H * scale


def resample_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``img`` (h, w, ...) resampled to (height, width) by the pixel whose
    area holds each output pixel's centre."""
    h, w = img.shape[:2]
    iy = np.minimum(((np.arange(height) + 0.5) * h / height).astype(np.int64), h - 1)
    ix = np.minimum(((np.arange(width) + 0.5) * w / width).astype(np.int64), w - 1)
    return img[iy[:, None], ix[None, :]]


class Canvas:
    """An (H, W, 3) float32 RGB image on white; pixel (i, j) is centred at
    x = j, y = i."""

    def __init__(self, width: int, height: int):
        self.img = np.ones((height, width, 3), np.float32)

    @property
    def height(self) -> int:
        return self.img.shape[0]

    @property
    def width(self) -> int:
        return self.img.shape[1]

    def blend(self, ys, xs, color, alpha=1.0) -> None:
        """Blend ``color`` ((3,) or (N, 3)) over the pixels (ys, xs) with
        ``alpha`` (scalar or (N,)); pixels off the canvas are dropped."""
        ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
        keep = (ys >= 0) & (ys < self.height) & (xs >= 0) & (xs < self.width)
        color = np.asarray(color, np.float32)
        alpha = np.broadcast_to(np.asarray(alpha, np.float32), ys.shape)[keep][:, None]
        if color.ndim == 2:
            color = color[keep]
        ys, xs = ys[keep], xs[keep]
        self.img[ys, xs] = (1 - alpha) * self.img[ys, xs] + alpha * color

    def polyline(self, xy: np.ndarray, color, width: float = 1.0) -> None:
        """An anti-aliased line ``width`` pixels wide through the points
        ``xy`` (N, 2); each pixel takes its largest coverage over the
        segments, so joints are not drawn twice. Non-finite points break
        the line."""
        xy = np.asarray(xy, np.float64)
        if len(xy) == 1:
            xy = np.concatenate([xy, xy])
        r = max(width, 1.0) / 2
        segs = [(a, b) for a, b in zip(xy[:-1], xy[1:]) if np.isfinite(a).all() and np.isfinite(b).all()]
        if not segs:
            return
        pts = np.array([p for s in segs for p in s])
        x0 = max(int(math.floor(pts[:, 0].min() - r - 1)), 0)
        y0 = max(int(math.floor(pts[:, 1].min() - r - 1)), 0)
        x1 = min(int(math.ceil(pts[:, 0].max() + r + 1)), self.width - 1)
        y1 = min(int(math.ceil(pts[:, 1].max() + r + 1)), self.height - 1)
        if x1 < x0 or y1 < y0:
            return
        cov = np.zeros((y1 - y0 + 1, x1 - x0 + 1), np.float32)
        for a, b in segs:
            bx0 = max(int(math.floor(min(a[0], b[0]) - r - 1)), x0)
            bx1 = min(int(math.ceil(max(a[0], b[0]) + r + 1)), x1)
            by0 = max(int(math.floor(min(a[1], b[1]) - r - 1)), y0)
            by1 = min(int(math.ceil(max(a[1], b[1]) + r + 1)), y1)
            if bx1 < bx0 or by1 < by0:
                continue
            gy, gx = np.mgrid[by0:by1 + 1, bx0:bx1 + 1].astype(np.float64)
            d = b - a
            dd = float(d @ d)
            t = np.zeros_like(gx) if dd == 0 else np.clip(
                ((gx - a[0]) * d[0] + (gy - a[1]) * d[1]) / dd, 0, 1)
            dist = np.hypot(gx - a[0] - t * d[0], gy - a[1] - t * d[1])
            c = np.clip(r + 0.5 - dist, 0, 1).astype(np.float32)
            sub = cov[by0 - y0:by1 - y0 + 1, bx0 - x0:bx1 - x0 + 1]
            np.maximum(sub, c, out=sub)
        region = self.img[y0:y1 + 1, x0:x1 + 1]
        region += cov[..., None] * (rgb(color) - region)

    def splat(self, xy: np.ndarray, colors, alpha: float = 1.0, size: int = 1) -> None:
        """Points ``xy`` (N, 2) as ``size``×``size`` squares, in order (a
        later point blends over an earlier one)."""
        xy = np.asarray(xy, np.float64)
        ok = np.isfinite(xy).all(axis=1)
        xy = xy[ok]
        colors = np.asarray(colors, np.float32)
        if colors.ndim == 2:
            colors = colors[ok]
        cx, cy = np.rint(xy[:, 0]).astype(np.int64), np.rint(xy[:, 1]).astype(np.int64)
        for dy in range(size):
            for dx in range(size):
                self.blend(cy + dy - size // 2, cx + dx - size // 2, colors, alpha)

    def disc(self, center, radius: float, face, edge=None, edge_width: float = 1.0) -> None:
        """A filled, anti-aliased disc, with an edge ring of ``edge``."""
        cx, cy = center
        if not (np.isfinite(cx) and np.isfinite(cy)):
            return
        r = radius + edge_width
        x0, x1 = max(int(cx - r - 1), 0), min(int(cx + r + 2), self.width)
        y0, y1 = max(int(cy - r - 1), 0), min(int(cy + r + 2), self.height)
        if x1 <= x0 or y1 <= y0:
            return
        gy, gx = np.mgrid[y0:y1, x0:x1]
        dist = np.hypot(gx - cx, gy - cy)
        region = self.img[y0:y1, x0:x1]
        inner = np.clip(radius + 0.5 - dist, 0, 1)[..., None]
        region += inner * (rgb(face) - region)
        if edge is not None:
            ring = np.clip(edge_width / 2 + 0.5 - np.abs(dist - radius), 0, 1)[..., None]
            region += ring * (rgb(edge) - region)

    def square(self, center, half: float, color) -> None:
        """A filled, anti-aliased square of side ``2·half`` about ``center``."""
        cx, cy = center
        if not (np.isfinite(cx) and np.isfinite(cy)):
            return
        x0, x1 = max(int(cx - half - 1), 0), min(int(cx + half + 2), self.width)
        y0, y1 = max(int(cy - half - 1), 0), min(int(cy + half + 2), self.height)
        if x1 <= x0 or y1 <= y0:
            return
        gy, gx = np.mgrid[y0:y1, x0:x1]
        cov = (np.clip(half + 0.5 - np.abs(gx - cx), 0, 1)
               * np.clip(half + 0.5 - np.abs(gy - cy), 0, 1))[..., None]
        region = self.img[y0:y1, x0:x1]
        region += cov * (rgb(color) - region)

    def dashed(self, xy: np.ndarray, color, width: float, on: float, off: float) -> None:
        """The line through ``xy`` (N, 2) in dashes of ``on`` pixels with
        gaps of ``off``, the pattern running on across the joints."""
        xy = np.asarray(xy, np.float64)
        period, start = on + off, 0.0  # the pattern's phase at each segment's start
        for a, b in zip(xy[:-1], xy[1:]):
            n = float(np.hypot(*(b - a)))
            if not (np.isfinite(a).all() and np.isfinite(b).all()) or n == 0:
                continue
            t = -start
            while t < n:
                lo, hi = max(t, 0.0), min(t + on, n)
                if hi > lo:
                    self.polyline(np.stack([a + (b - a) * lo / n, a + (b - a) * hi / n]),
                                  color, width)
                t += period
            start = (start + n) % period

    def text(self, x: float, y: float, s: str, color="k", scale: int = 1,
             ha: str = "left", va: str = "baseline", vertical: bool = False) -> None:
        """``s`` at (x, y): ``ha`` left, center or right; ``va`` baseline,
        top, center or bottom. ``vertical`` turns it a quarter
        anticlockwise about its box's centre (then (x, y) is that centre)."""
        w, h = text_size(s, scale)
        mask = np.concatenate([_GLYPHS.get(ch, _GLYPHS["?"]) for ch in s], axis=1) if s else \
            np.zeros((GLYPH_H, 0), bool)
        mask = np.kron(mask, np.ones((scale, scale), bool))
        if vertical:
            mask = np.rot90(mask)
            x, y = int(round(x - h / 2)), int(round(y - w / 2))
        else:
            x = int(round(x - {"left": 0, "center": w / 2, "right": w}[ha]))
            y = int(round(y - {"baseline": _BASELINE * scale, "top": 0, "center": h / 2,
                               "bottom": h}[va]))
        ys, xs = np.nonzero(mask)
        self.blend(ys + y, xs + x, rgb(color))

    def image(self, x0: int, y0: int, img: np.ndarray) -> None:
        """Paste an (h, w, 3) float image in [0, 1] with its top-left at (x0, y0)."""
        h, w = img.shape[:2]
        self.img[y0:y0 + h, x0:x0 + w] = img[:self.height - y0, :self.width - x0]

    def save(self, path: str) -> None:
        write_png(path, (np.clip(self.img, 0, 1) * 255 + 0.5).astype(np.uint8))


class _Axes:
    """A rectangle (x0, y0, width, height) of the figure, in pixels."""

    def __init__(self, rect: Tuple[int, int, int, int]):
        self.rect = rect
        self.title = ""
        self.title_scale = 2

    def set_title(self, title: str, small: bool = False) -> None:
        self.title = title
        self.title_scale = 1 if small else 2

    def _draw_title(self, canvas: Canvas) -> None:
        x0, y0, w, _ = self.rect
        if self.title:
            canvas.text(x0 + w / 2, y0 + 2, self.title, "k", self.title_scale, "center", "top")


class ImageAxes(_Axes):
    """An image under a title, fit to the rectangle with its aspect kept;
    :attr:`extent` is where it landed: (x0, y0, width, height)."""

    def __init__(self, rect):
        super().__init__(rect)
        self.img: Optional[np.ndarray] = None
        self.extent: Optional[Tuple[int, int, int, int]] = None

    def imshow(self, img: np.ndarray) -> None:
        self.img = np.asarray(img, np.float32)

    def layout(self) -> None:
        x0, y0, w, h = self.rect
        top = GLYPH_H * self.title_scale + 6
        ih, iw = self.img.shape[:2]
        s = min(w / iw, (h - top) / ih)
        pw, ph = max(int(iw * s), 1), max(int(ih * s), 1)
        self.extent = (x0 + (w - pw) // 2, y0 + top + (h - top - ph) // 2, pw, ph)

    def render(self, canvas: Canvas) -> None:
        self._draw_title(canvas)
        if self.img is None:
            return
        self.layout()
        x, y, w, h = self.extent
        canvas.image(x, y, resample_nearest(self.img, h, w))


class Axes3D(_Axes):
    """A 3-D axes: what is drawn is recorded and projected at render time,
    when the limits are known (the data's, or those set)."""

    BOX = np.array([4.0, 4.0, 3.0]) / 4.0  # matplotlib's default box aspect

    def __init__(self, rect, elev: float = 30.0, azim: float = -60.0):
        super().__init__(rect)
        self.elev, self.azim = elev, azim
        self.items: List[tuple] = []
        self.lims: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.labels = ("", "", "")
        self.show_legend = False

    # -- recording
    def plot(self, pts, color, width: float, label: Optional[str] = None) -> None:
        self.items.append(("plot", np.asarray(pts, np.float64), color, width, label))

    def scatter(self, pts, colors, size: int = 1, alpha: float = 1.0) -> None:
        self.items.append(("scatter", np.asarray(pts, np.float64), colors, size, alpha))

    def markers(self, pts, radius: float, face, edge, edge_width: float, label=None) -> None:
        self.items.append(("markers", np.asarray(pts, np.float64), radius, face, edge,
                           edge_width, label))

    def quiver(self, starts, deltas, color, width: float, ratio: float = 0.25) -> None:
        self.items.append(("quiver", np.asarray(starts, np.float64),
                           np.asarray(deltas, np.float64), color, width, ratio))

    def text(self, pt, s: str, color) -> None:
        self.items.append(("text", np.asarray(pt, np.float64)[None], s, color))

    def set_lims(self, lo, hi) -> None:
        self.lims = (np.asarray(lo, np.float64), np.asarray(hi, np.float64))

    def set_labels(self, x: str, y: str, z: str) -> None:
        self.labels = (x, y, z)

    def legend(self) -> None:
        self.show_legend = True

    # -- projection
    def data_lims(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.lims is not None:
            return self.lims
        pts = [it[1] for it in self.items if it[0] != "text"]
        pts += [it[1] + it[2] for it in self.items if it[0] == "quiver"]
        pts = [p[np.isfinite(p).all(axis=1)] for p in pts]
        pts = np.concatenate(pts) if pts else np.zeros((0, 3))
        if len(pts) == 0:
            return np.zeros(3), np.ones(3)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        pad = np.where(hi > lo, 0.0, np.maximum(np.abs(lo) * 0.05, 1e-3))
        return lo - pad, hi + pad

    def _basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        e, a = math.radians(self.elev), math.radians(self.azim)
        right = np.array([-math.sin(a), math.cos(a), 0.0])
        up = np.array([-math.sin(e) * math.cos(a), -math.sin(e) * math.sin(a), math.cos(e)])
        toward = np.array([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a), math.sin(e)])
        return right, up, toward

    def _fit(self):
        """Scale and offset that put the projected box in the rectangle."""
        corners = (np.array(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij")).reshape(3, -1).T
                   - 0.5) * self.BOX
        right, up, _ = self._basis()
        sx, sy = corners @ right, corners @ up
        x0, y0, w, h = self.rect
        top, margin = GLYPH_H * self.title_scale + 8, 2 * GLYPH_H + 4
        s = min((w - 2 * margin) / (sx.max() - sx.min()),
                (h - top - 2 * margin) / (sy.max() - sy.min()))
        cx = x0 + w / 2 - s * (sx.max() + sx.min()) / 2
        cy = y0 + top + (h - top) / 2 + s * (sy.max() + sy.min()) / 2
        return s, cx, cy

    def project(self, pts) -> np.ndarray:
        """Data points (N, 3) → pixel coordinates (N, 2) in the figure."""
        lo, hi = self.data_lims()
        p = ((np.asarray(pts, np.float64) - lo) / (hi - lo) - 0.5) * self.BOX
        right, up, _ = self._basis()
        s, cx, cy = self._fit()
        return np.stack([cx + s * (p @ right), cy - s * (p @ up)], axis=-1)

    def depth(self, pts) -> np.ndarray:
        """Distance toward the viewer (larger is nearer)."""
        lo, hi = self.data_lims()
        return (((np.asarray(pts, np.float64) - lo) / (hi - lo) - 0.5) * self.BOX) @ self._basis()[2]

    # -- rendering
    def _draw_box(self, canvas: Canvas) -> None:
        lo, hi = self.data_lims()
        grey = NAMED["lightgray"]
        for axis in range(3):
            for i in (0, 1):
                for j in (0, 1):
                    a, b = lo.copy(), lo.copy()
                    others = [k for k in range(3) if k != axis]
                    for k, f in zip(others, (i, j)):
                        a[k] = b[k] = (lo, hi)[f][k]
                    b[axis] = hi[axis]
                    canvas.polyline(self.project(np.stack([a, b])), grey, 1.0)
        # each label beside the middle of its axis's lowest edge, away from the box
        center = self.project(((lo + hi) / 2)[None])[0]
        for axis, label in enumerate(self.labels):
            if not label:
                continue
            a = lo.copy()
            b = lo.copy()
            b[axis] = hi[axis]
            mid = self.project(((a + b) / 2)[None])[0]
            d = mid - center
            d = d / max(np.hypot(*d), 1e-9)
            canvas.text(*(mid + d * 2 * GLYPH_H), label, "k", 1, "center", "center")

    def _draw_legend(self, canvas: Canvas) -> None:
        entries = [(it[0], it[-1], it) for it in self.items
                   if it[0] in ("plot", "markers") and it[-1]]
        if not entries:
            return
        x0, y0, w, _ = self.rect
        tw = max(text_size(label)[0] for _, label, _ in entries)
        bw, bh = tw + 40, len(entries) * (GLYPH_H + 6) + 6
        bx, by = x0 + w - bw - 4, y0 + GLYPH_H * self.title_scale + 10
        box = np.array([[bx, by], [bx + bw, by], [bx + bw, by + bh], [bx, by + bh], [bx, by]])
        canvas.img[by:by + bh, bx:bx + bw] = 1.0
        canvas.polyline(box, NAMED["lightgray"], 1.0)
        for n, (kind, label, it) in enumerate(entries):
            yc = by + 6 + n * (GLYPH_H + 6) + GLYPH_H / 2
            if kind == "plot":
                canvas.polyline(np.array([[bx + 6, yc], [bx + 28, yc]]), it[2], it[3])
            else:
                canvas.disc((bx + 17, yc), min(it[2], 5), it[3], it[4], it[5])
            canvas.text(bx + 34, yc, label, "k", 1, "left", "center")

    def render(self, canvas: Canvas) -> None:
        self._draw_box(canvas)
        for it in self.items:
            kind = it[0]
            if kind == "plot":
                canvas.polyline(self.project(it[1]), it[2], it[3])
            elif kind == "scatter":
                pts, colors = it[1], rgb(it[2]) if isinstance(it[2], str) else np.asarray(it[2])
                order = np.argsort(self.depth(pts), kind="stable")  # far first
                if colors.ndim == 2:
                    colors = colors[order]
                canvas.splat(self.project(pts[order]), colors, it[4], it[3])
            elif kind == "markers":
                for xy in self.project(it[1]):
                    canvas.disc(xy, it[2], it[3], it[4], it[5])
            elif kind == "quiver":
                a, b = self.project(it[1]), self.project(it[1] + it[2])
                for p, q in zip(a, b):
                    d = q - p
                    n = np.hypot(*d)
                    if not np.isfinite(n) or n == 0:
                        continue
                    back = -d / n * it[5] * n
                    head = []
                    for ang in (0.35, -0.35):  # about 20°, each side
                        c, s = math.cos(ang), math.sin(ang)
                        head.append(q + np.array([c * back[0] - s * back[1],
                                                  s * back[0] + c * back[1]]))
                    canvas.polyline(np.stack([p, q]), it[3], it[4])
                    canvas.polyline(np.stack([head[0], q, head[1]]), it[3], it[4])
            elif kind == "text":
                x, y = self.project(it[1])[0]
                canvas.text(x, y, it[2], it[3])
        self._draw_title(canvas)
        if self.show_legend:
            self._draw_legend(canvas)


class Axes2D(_Axes):
    """A 2-D line plot, recorded and drawn at render time as matplotlib's
    ``Axes.plot`` draws it: linear axes over the data's range widened by 5 %
    a side, ticks at multiples of 1, 2, 2.5 or 5 × 10^k under each axis's
    tick budget, a frame, tick labels, axis labels (the y label turned a
    quarter), a title and a legend where the lines cover it least.
    ``dpi`` converts the widths and marker sizes given in points."""

    MARGIN = 0.05  # matplotlib's axes.xmargin and ymargin
    LW = 1.5  # matplotlib's lines.linewidth, points
    STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)
    TICK = 4  # tick length in pixels

    def __init__(self, rect, dpi: int = DPI):
        super().__init__(rect)
        self.pt = dpi / 72.0
        self.lines: List[tuple] = []
        self.xlabel = self.ylabel = ""
        self.show_legend = False

    def plot(self, xs, ys, fmt: str = "-", label: Optional[str] = None,
             ms: float = 6.0) -> None:
        """A line through (xs, ys) in the next colour of matplotlib's cycle.
        ``fmt``: ``"-"`` or ``"--"`` (dashed), then an optional ``"o"``
        (circle) or ``"s"`` (square) marker of ``ms`` points at each point."""
        style, marker = (fmt[:-1], fmt[-1]) if fmt[-1] in "os" else (fmt, "")
        if style not in ("-", "--"):
            raise ValueError(f"line style {fmt!r} is not drawn")
        color = CYCLE[len(self.lines) % len(CYCLE)]
        self.lines.append((np.asarray(xs, np.float64), np.asarray(ys, np.float64), style,
                           marker, color, label, ms))

    def set_xlabel(self, label: str) -> None:
        self.xlabel = label

    def set_ylabel(self, label: str) -> None:
        self.ylabel = label

    def legend(self) -> None:
        self.show_legend = True

    # -- layout
    def limits(self) -> Tuple[float, float, float, float]:
        """(x0, x1, y0, y1): the data's range with the margins."""
        out = []
        for i in (0, 1):
            v = np.concatenate([ln[i] for ln in self.lines]) if self.lines else np.zeros(0)
            v = v[np.isfinite(v)]
            lo, hi = (float(v.min()), float(v.max())) if len(v) else (0.0, 1.0)
            if hi == lo:  # a flat range: ±5 % of the value (±0.05 about 0)
                pad = abs(lo) * self.MARGIN or self.MARGIN
                lo, hi = lo - pad, hi + pad
            pad = (hi - lo) * self.MARGIN
            out += [lo - pad, hi + pad]
        return tuple(out)

    def ticks(self, lo: float, hi: float, n_max: int) -> Tuple[np.ndarray, List[str]]:
        """Ticks in [lo, hi] at the smallest step of ``STEPS`` × 10^k that
        gives at most ``n_max`` intervals, and their labels."""
        base = 10.0 ** math.floor(math.log10((hi - lo) / max(n_max, 1)))
        step = next(base * m for m in self.STEPS if (hi - lo) / (base * m) <= n_max)
        ticks = np.arange(math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9) + 1) * step
        ticks[np.abs(ticks) < step * 1e-6] = 0.0  # no "-0.00"
        decimals = max(0, -math.floor(math.log10(step) + 1e-9))
        if not np.allclose(np.round(ticks, decimals), ticks, rtol=0, atol=step * 1e-6):
            decimals += 1  # 2.5 × 10^k
        return ticks, [f"{t:.{decimals}f}" for t in ticks]

    def plot_rect(self) -> Tuple[float, float, float, float]:
        """(left, top, width, height) in pixels of the area the data spans."""
        x0, y0, w, h = self.rect
        _, _, ylo, yhi = self.limits()
        _, ylabels = self.ticks(ylo, yhi, max(2, int(h // 60)))
        left = x0 + max(text_size(s)[0] for s in ylabels) + self.TICK + 6 + (
            GLYPH_H + 10 if self.ylabel else 4)
        top = y0 + (GLYPH_H * self.title_scale + 10 if self.title else 8)
        bottom = y0 + h - GLYPH_H - self.TICK - 6 - (GLYPH_H + 8 if self.xlabel else 2)
        right = x0 + w - 12
        return left, top, right - left, bottom - top

    def to_pixel(self, xs, ys) -> np.ndarray:
        """Data points → (N, 2) pixel coordinates in the figure."""
        x0, x1, y0, y1 = self.limits()
        left, top, pw, ph = self.plot_rect()
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        return np.stack([left + (xs - x0) / (x1 - x0) * pw,
                         top + ph - (ys - y0) / (y1 - y0) * ph], axis=-1)

    # -- rendering
    def _draw_marker(self, canvas: Canvas, xy, marker: str, ms: float, color) -> None:
        r = ms * self.pt / 2
        if marker == "o":
            canvas.disc(xy, r, color)
        elif marker == "s":
            canvas.square(xy, r, color)

    def _draw_line(self, canvas: Canvas, xy, style: str, color) -> None:
        width = self.LW * self.pt
        if style == "--":  # matplotlib's dashes, (3.7, 1.6) line widths
            canvas.dashed(xy, color, width, 3.7 * width, 1.6 * width)
        else:
            canvas.polyline(xy, color, width)

    def _draw_legend(self, canvas: Canvas) -> None:
        entries = [ln for ln in self.lines if ln[5]]
        if not entries:
            return
        left, top, pw, ph = self.plot_rect()
        bw = max(text_size(ln[5])[0] for ln in entries) + 44
        bh = len(entries) * (GLYPH_H + 8) + 6
        # matplotlib's "best": of its nine places, in its order, the first
        # whose box covers the fewest points of the lines (sampled along them)
        xl, xc, xr = left + 6, left + (pw - bw) / 2, left + pw - bw - 6
        yt, yc, yb = top + 6, top + (ph - bh) / 2, top + ph - bh - 6
        places = [(xr, yt), (xl, yt), (xl, yb), (xr, yb), (xr, yc), (xl, yc), (xr, yc),
                  (xc, yb), (xc, yt), (xc, yc)]
        t = np.linspace(0, 1, 16, endpoint=False)[:, None]
        pts = np.concatenate([np.concatenate([a + t * (b - a) for a, b in zip(xy[:-1], xy[1:])]
                                             + [xy[-1:]])
                              for xy in (self.to_pixel(ln[0], ln[1]) for ln in self.lines)])

        def covered(place):
            bx, by = place
            return int(np.sum((pts[:, 0] >= bx) & (pts[:, 0] <= bx + bw)
                              & (pts[:, 1] >= by) & (pts[:, 1] <= by + bh)))
        bx, by = min(places, key=covered)
        bx, by = int(bx), int(by)
        canvas.img[by:by + bh, bx:bx + bw] = 1.0
        canvas.polyline(np.array([[bx, by], [bx + bw, by], [bx + bw, by + bh], [bx, by + bh],
                                  [bx, by]], np.float64), NAMED["lightgray"], 1.0)
        for n, (_, _, style, marker, color, label, ms) in enumerate(entries):
            yc = by + 7 + n * (GLYPH_H + 8) + GLYPH_H / 2
            self._draw_line(canvas, np.array([[bx + 6, yc], [bx + 34, yc]]), style, color)
            self._draw_marker(canvas, (bx + 20, yc), marker, ms, color)
            canvas.text(bx + 40, yc, label, "k", 1, "left", "center")

    def render(self, canvas: Canvas) -> None:
        x0, x1, y0, y1 = self.limits()
        left, top, pw, ph = self.plot_rect()
        for xs, ys, style, marker, color, _, ms in self.lines:
            xy = self.to_pixel(xs, ys)
            self._draw_line(canvas, xy, style, color)
            for p in xy:
                self._draw_marker(canvas, p, marker, ms, color)
        # the frame and the ticks over the lines, the labels outside
        frame = np.array([[left, top], [left + pw, top], [left + pw, top + ph],
                          [left, top + ph], [left, top]])
        canvas.polyline(frame, "k", 1.0)
        xticks, xlabels = self.ticks(x0, x1, max(2, int(self.rect[2] // 80)))
        for t, s in zip(xticks, xlabels):
            px = left + (t - x0) / (x1 - x0) * pw
            canvas.polyline(np.array([[px, top + ph], [px, top + ph + self.TICK]]), "k", 1.0)
            canvas.text(px, top + ph + self.TICK + 3, s, "k", 1, "center", "top")
        yticks, ylabels = self.ticks(y0, y1, max(2, int(self.rect[3] // 60)))
        for t, s in zip(yticks, ylabels):
            py = top + ph - (t - y0) / (y1 - y0) * ph
            canvas.polyline(np.array([[left - self.TICK, py], [left, py]]), "k", 1.0)
            canvas.text(left - self.TICK - 3, py, s, "k", 1, "right", "center")
        if self.xlabel:
            canvas.text(left + pw / 2, top + ph + self.TICK + GLYPH_H + 10, self.xlabel, "k", 1,
                        "center", "top")
        if self.ylabel:
            canvas.text(self.rect[0] + 4 + GLYPH_H / 2, top + ph / 2, self.ylabel, "k", 1,
                        vertical=True)
        if self.title:
            canvas.text(left + pw / 2, self.rect[1] + 4, self.title, "k", self.title_scale,
                        "center", "top")
        if self.show_legend:
            self._draw_legend(canvas)


class Figure:
    """A white figure of ``width_in`` × ``height_in`` inches at ``dpi``
    (130 by default, the reference's savefig dpi)."""

    def __init__(self, width_in: float, height_in: float, dpi: int = DPI):
        self.width = int(round(width_in * dpi))
        self.height = int(round(height_in * dpi))
        self.axes: List[_Axes] = []
        self.suptitle = ""

    def add_axes(self, axes: _Axes) -> _Axes:
        self.axes.append(axes)
        return axes

    def grid(self, n_rows: int, n_cols: int, row: int, col: int,
             top: int = 0) -> Tuple[int, int, int, int]:
        """The rectangle of cell (row, col) of an n_rows × n_cols grid below
        ``top`` pixels."""
        w, h = self.width // n_cols, (self.height - top) // n_rows
        return col * w, top + row * h, w, h

    def render(self) -> Canvas:
        canvas = Canvas(self.width, self.height)
        for ax in self.axes:
            ax.render(canvas)
        if self.suptitle:
            canvas.text(self.width / 2, 4, self.suptitle, "k", 2, "center", "top")
        return canvas

    def savefig(self, path: str) -> None:
        self.render().save(path)
