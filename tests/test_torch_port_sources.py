"""colvo_torch's PNG codec, frame sources and benchmark loader against
colvo's (which read through cv2), on the same files: the codec bit for bit
against ``cv2.imread`` on files that cv2, PIL and a per-row filter writer
made; the sources bit for bit at native size and within 1 LSB after an
area resize; the loader on a directory built as ``tests/test_benchmark.py``
builds one."""

import inspect
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import colvo.data.benchmark as jax_bench
import colvo.data.sources as jax_sources
from colvo.data import render_sequence as jax_render_sequence
from colvo_torch.data import benchmark, png, sources
from colvo_torch.data import render_sequence

torch.set_num_threads(2)

H, W = 64, 96


def _image(h, w, seed=0):
    """Smooth structure plus noise, so that encoders pick mixed filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 17.0) * 100 + 120 + yy % 7, np.cos(yy / 13.0) * 90 + 128,
                     (xx + yy) % 256], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _filtered_png(path, rows, ctype, depth, bpp):
    """A PNG whose row r uses filter type r % 5, filtered in Python."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for r in range(h):
        cur = rows[r].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = r % 5
        if f == 0:
            pred = np.zeros(stride, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    w = stride // bpp
    chunk = png._chunk
    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                            0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _adam7_png(path, px, ctype, depth, palette=None):
    """An Adam7-interlaced PNG of the raw (h, w, bytes a pixel) uint8
    pixels, written here with zlib and struct (neither cv2 nor PIL writes
    one): each pass's sub-image filtered as ``_filtered_png`` filters rows
    (row r of a pass with type r % 5), the passes one after the other."""
    h, w, bpp = px.shape
    out = b""
    for x0, y0, dx, dy in ADAM7:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue  # an empty pass has no bytes at all
        _filtered_png(path, sub.reshape(sub.shape[0], -1), ctype, depth, bpp)
        out += zlib.decompress(_chunks(path)[b"IDAT"])
    chunk = png._chunk
    body = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    with open(path, "wb") as fh:
        fh.write(body + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b""))


def _chunks(path):
    data, pos, out = open(path, "rb").read(), 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        out[tag] = out.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


@pytest.mark.parametrize("h, w", [(37, 53), (5, 3)], ids=["37x53", "5x3-empty-passes"])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "palette", "rgb16", "gray16"])
def test_read_png_adam7_equals_cv2_imread(tmp_path, kind, h, w):
    """Adam7 files at 8 and 16 bits, gray, RGB, RGBA and palette, read as
    cv2.imread reads them (IMREAD_UNCHANGED for 16-bit gray) and as the
    same pixels non-interlaced; at 5×3 passes 2, 3 and 4 are empty."""
    rng = np.random.default_rng(7)
    img = _image(h, w, seed=5)
    palette = None
    if kind == "gray8":
        ctype, depth, px = 0, 8, img[..., :1]
    elif kind == "rgb8":
        ctype, depth, px = 2, 8, img
    elif kind == "rgba8":
        ctype, depth, px = 6, 8, np.concatenate([img, img[..., 1:2]], -1)
    elif kind == "palette":
        palette = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        ctype, depth, px = 3, 8, rng.integers(0, 40, (h, w, 1)).astype(np.uint8)
    else:
        ch = 3 if kind == "rgb16" else 1
        ctype, depth = (2 if ch == 3 else 0), 16
        px = rng.integers(0, 65536, (h, w, ch)).astype(">u2").view(np.uint8)
    p, flat = str(tmp_path / "adam7.png"), str(tmp_path / "flat.png")
    _adam7_png(p, px, ctype, depth, palette)
    _filtered_png(flat, px.reshape(h, -1), ctype, depth, px.shape[2])
    if palette is not None:  # the flat file needs the palette too
        c = _chunks(flat)
        with open(flat, "wb") as fh:
            fh.write(png.SIGNATURE + png._chunk(b"IHDR", c[b"IHDR"])
                     + png._chunk(b"PLTE", palette.tobytes())
                     + png._chunk(b"IDAT", c[b"IDAT"]) + png._chunk(b"IEND", b""))
    got = png.read_png(p)
    want = cv2.imread(p, cv2.IMREAD_UNCHANGED) if kind == "gray16" else _cv2_rgb(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, png.read_png(flat))


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """PNG files of every colour type and bit depth the codec reads."""
    d = tmp_path_factory.mktemp("png")
    img = _image(37, 53)
    rng = np.random.default_rng(1)
    files = {
        "cv_rgb": lambda p: cv2.imwrite(p, img[..., ::-1]),
        "cv_gray": lambda p: cv2.imwrite(p, img[..., 0]),
        "cv_rgba": lambda p: cv2.imwrite(p, np.concatenate([img[..., ::-1], img[..., :1]], -1)),
        "cv_rgb16": lambda p: cv2.imwrite(p, rng.integers(0, 65536, (37, 53, 3)).astype(np.uint16)),
        "pil_rgb": lambda p: Image.fromarray(img).save(p),
        "pil_rgba": lambda p: Image.fromarray(np.concatenate([img, img[..., 1:2]], -1), "RGBA").save(p),
        "pil_gray": lambda p: Image.fromarray(img[..., 0]).save(p),
        "pil_gray_alpha": lambda p: Image.fromarray(img[..., 0]).convert("LA").save(p),
        "pil_palette": lambda p: Image.fromarray(img).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=50).save(p),
        "filters_rgb": lambda p: _filtered_png(p, img.reshape(37, -1), 2, 8, 3),
        "filters_rgba": lambda p: _filtered_png(
            p, np.concatenate([img, img[..., :1]], -1).reshape(37, -1), 6, 8, 4),
        "filters_rgb16": lambda p: _filtered_png(
            p, rng.integers(0, 65536, (37, 53, 3)).astype(">u2").view(np.uint8).reshape(37, -1),
            2, 16, 6),
    }
    for name, write in files.items():
        write(str(d / f"{name}.png"))
    return d, sorted(files)


def _filter_types(path):
    """The filter-type bytes of a non-interlaced PNG file's rows."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * (stride + 1)] for r in range(h)}


def test_read_png_equals_cv2_imread(png_dir):
    """RGB, gray, gray+alpha, RGBA, palette and 16-bit colour as
    IMREAD_COLOR gives them (BGR→RGB), bit for bit; all five row filters
    occur among the files."""
    d, names = png_dir
    seen = set()
    for name in names:
        p = str(d / f"{name}.png")
        got, want = png.read_png(p), _cv2_rgb(p)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        seen |= _filter_types(p)
    assert seen == {0, 1, 2, 3, 4}


def test_read_png_16bit_gray_as_imread_unchanged(tmp_path):
    g16 = np.random.default_rng(2).integers(0, 65536, (29, 41)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "cv.png"), g16)
    _filtered_png(str(tmp_path / "filtered.png"), g16.astype(">u2").view(np.uint8).reshape(29, -1),
                  0, 16, 2)
    for name in ("cv", "filtered"):
        p = str(tmp_path / f"{name}.png")
        got, want = png.read_png(p), cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, g16)


def test_write_png_round_trip_and_readers_agree(tmp_path):
    img = _image(23, 31, seed=4)
    g16 = np.random.default_rng(3).integers(0, 65536, (23, 31)).astype(np.uint16)
    png.write_png(str(tmp_path / "rgb.png"), img)
    png.write_png(str(tmp_path / "g16.png"), g16)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "rgb.png")), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "g16.png")), g16)
    np.testing.assert_array_equal(_cv2_rgb(str(tmp_path / "rgb.png")), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g16.png"), cv2.IMREAD_UNCHANGED), g16)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), img)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), img.astype(np.float32))


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    img = _image(16, 16)
    data = png.png_bytes(img)  # the same file with IHDR's interlace byte set
    for method in (1, 2):
        ihdr = png._chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 2, 0, 0, method))
        (tmp_path / "interlaced.png").write_bytes(data[:8] + ihdr + data[8 + len(ihdr):])
        # (a non-interlaced stream is no Adam7 stream: its rows cut the passes wrongly)
        with pytest.raises(ValueError, match="Adam7|row" if method == 1 else "interlace method"):
            png.read_png(str(tmp_path / "interlaced.png"))
    Image.fromarray(img[..., 0] > 128).save(tmp_path / "bits1.png")
    with pytest.raises(NotImplementedError, match="bit depth 1"):
        png.read_png(str(tmp_path / "bits1.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(tmp_path / "not.png"))
    rows = np.zeros((3, 13), np.uint8)
    rows[1, 0] = 7  # filter type 7
    with pytest.raises(ValueError, match="row 1"):
        from colvo_torch import native

        native.png_unfilter(rows.tobytes(), 3, 12, 3)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    """A frame dir at 1080×1350 (3 frames, PNG through cv2)."""
    d = tmp_path_factory.mktemp("frames")
    for i in range(3):
        cv2.imwrite(str(d / f"{i:06d}.png"), _image(1080, 1350, seed=10 + i)[..., ::-1])
    return str(d)


@pytest.mark.parametrize("pixel_format", ["rgb8", "float", "i420"])
def test_frame_dir_source_at_native_size_is_bit_equal(frame_dir, pixel_format):
    got = list(sources.FrameDirSource(frame_dir, 1350, 1080, pixel_format))
    want = list(jax_sources.FrameDirSource(frame_dir, 1350, 1080, pixel_format))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [(320, 256), (675, 540), (96, 64)], ids=["down_4.22", "down_x2",
                                                                       "down_far"])
@pytest.mark.parametrize("pixel_format", ["rgb8", "float", "i420"])
def test_frame_dir_source_resized_within_one_lsb(frame_dir, size, pixel_format):
    """1350×1080 → 320×256 (non-integer factor), ×2 and far down: within
    1/255 (float) or 1 LSB (uint8, I420). I420 at ×2 (675 columns) has
    no chroma layout: both packages refuse it."""
    w, h = size
    if pixel_format == "i420" and w % 2:
        with pytest.raises(ValueError, match="even"):
            sources.open_source(frame_dir, w, h, pixel_format=pixel_format)[0]
        with pytest.raises(cv2.error):
            jax_sources.open_source(frame_dir, w, h, pixel_format=pixel_format)[0]
        return
    got = list(sources.open_source(frame_dir, w, h, pixel_format=pixel_format))
    want = list(jax_sources.open_source(frame_dir, w, h, pixel_format=pixel_format))
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        tol = 1 / 255 + 1e-6 if g.dtype == np.float32 else 1
        assert np.abs(g.astype(np.float64) - r.astype(np.float64)).max() <= tol


@pytest.mark.parametrize("src,dst", [((64, 96), (128, 192)), ((37, 53), (100, 70)),
                                     ((64, 96), (96, 150)), ((100, 60), (50, 90)),
                                     ((99, 101), (33, 50))],
                         ids=["up_x2", "up_odd", "up_1.5", "mixed", "down_odd"])
def test_area_resize_equals_cv2_within_one_lsb(src, dst):
    """Up (where cv2's INTER_AREA interpolates linearly), mixed and odd
    factors, on structure and on noise; float frames to float rounding."""
    for img in (_image(*src, seed=5),
                np.random.default_rng(6).integers(0, 256, (*src, 3)).astype(np.uint8)):
        got = sources._resize(img, dst[1], dst[0])
        want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        f = img.astype(np.float32) / 255
        np.testing.assert_allclose(sources._resize(f, dst[1], dst[0]),
                                   cv2.resize(f, (dst[1], dst[0]), interpolation=cv2.INTER_AREA),
                                   rtol=0, atol=1e-6)
        gray = np.ascontiguousarray(img[..., 0])  # one channel, (h, w)
        got = sources._resize(gray, dst[1], dst[0])
        assert got.shape == dst
        assert np.abs(got.astype(int) - cv2.resize(gray, (dst[1], dst[0]),
                                                   interpolation=cv2.INTER_AREA)).max() <= 1


def test_i420_equals_cv2_on_noise():
    """cv2 takes each 2×2 block's chroma from its top-left pixel; the port
    packs as it does (the block average would be 100+ LSB off on noise)."""
    rgb = np.random.default_rng(7).integers(0, 256, (64, 96, 3)).astype(np.uint8)
    got = sources._emit(rgb, "i420")
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)
    assert got.shape == want.shape == (96, 96)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got, jax_sources._emit(rgb, "i420"))


def test_video_source_equals_reference_with_stride(tmp_path):
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (160, 120))
    assert writer.isOpened()
    for i in range(7):
        writer.write(_image(120, 160, seed=20 + i)[..., ::-1])
    writer.release()
    for size in ((160, 120), (96, 64)):
        got = sources.VideoFrameSource(path, *size, stride=2, pixel_format="rgb8")
        want = jax_sources.VideoFrameSource(path, *size, stride=2, pixel_format="rgb8")
        assert len(got) == len(want) == 4
        g, w = np.stack(list(got)), np.stack(list(want))
        assert g.shape == w.shape == (4, size[1], size[0], 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= (0 if size == (160, 120) else 1)


def test_jpeg_without_cv2_raises_import_error_naming_the_file(tmp_path, monkeypatch):
    cv2.imwrite(str(tmp_path / "000000.jpg"), _image(32, 48))
    src = sources.FrameDirSource(str(tmp_path), 48, 32, "rgb8")
    assert src[0].shape == (32, 48, 3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="000000.jpg"):
        src[0]
    with pytest.raises(ImportError, match="clip.avi"):
        sources.VideoFrameSource(str(tmp_path / "clip.avi"), 48, 32)


def test_png_frames_are_read_without_cv2(tmp_path, monkeypatch):
    img = _image(32, 48)
    png.write_png(str(tmp_path / "000000.png"), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(sources.FrameDirSource(str(tmp_path), 48, 32, "rgb8")[0], img)
    assert sources.FrameDirSource(str(tmp_path), 24, 16, "i420")[0].shape == (24, 24)


def _write_sequence(root, name, seq, depth_fmt="npy", pose_fmt=16, k_floats=9):
    """As tests/test_benchmark.py writes one, plus TUM poses and 4-float K."""
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "rgb"))
    os.makedirs(os.path.join(d, "depth"))
    for i, (f, gt) in enumerate(zip(seq.frames, seq.depths)):
        bgr = cv2.cvtColor(np.clip(f * 255 + 0.5, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imwrite(os.path.join(d, "rgb", f"{i:06d}.png"), bgr)
        if depth_fmt == "npy":
            np.save(os.path.join(d, "depth", f"{i:06d}.npy"), gt)
        else:
            scale = float(seq.depths.max()) / 65535.0
            raw = np.clip(gt / scale, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(d, "depth", f"{i:06d}.png"), raw)
            np.savetxt(os.path.join(d, "depth_scale.txt"), [scale])
    if pose_fmt == 16:
        rows = seq.poses.reshape(len(seq.poses), 16)
    elif pose_fmt == 12:
        rows = seq.poses[:, :3, :].reshape(len(seq.poses), 12)
    else:  # TUM: t tx ty tz qx qy qz qw, from the rotation
        from scipy.spatial.transform import Rotation

        q = Rotation.from_matrix(seq.poses[:, :3, :3].astype(np.float64)).as_quat()
        rows = np.concatenate([np.arange(len(seq.poses))[:, None], seq.poses[:, :3, 3], q], 1)
    np.savetxt(os.path.join(d, "poses.txt"), rows)
    k = seq.k
    vals = k.reshape(-1) if k_floats == 9 else [k[0, 0], k[1, 1], k[0, 2], k[1, 2]]
    np.savetxt(os.path.join(d, "intrinsics.txt"), vals)


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    seq_a = render_sequence(n_frames=6, height=H, width=W, seed=1)
    seq_b = render_sequence(n_frames=5, height=H, width=W, seed=2)
    seq_c = render_sequence(n_frames=4, height=H, width=W, seed=3)
    np.testing.assert_array_equal(seq_a.frames, jax_render_sequence(n_frames=6, height=H,
                                                                    width=W, seed=1).frames)
    _write_sequence(root, "seq_a", seq_a, "npy", 16, 9)
    _write_sequence(root, "seq_b", seq_b, "png", 12, 4)
    _write_sequence(root, "seq_c", seq_c, "png", 8, 4)
    return root, {"seq_a": seq_a, "seq_b": seq_b, "seq_c": seq_c}


@pytest.mark.parametrize("size", [(W, H), (W // 2, H // 2), (144, 80)], ids=["native", "half",
                                                                           "up"])
def test_benchmark_loader_matches_reference(bench_root, size):
    """Frames within 1/255, K to 1e-6, depths bit for bit (npy and 16-bit
    PNG, nearest-resampled), poses to 1e-12 (16, 12 and TUM's 8 floats)."""
    root, seqs = bench_root
    assert benchmark.list_sequences(root) == jax_bench.list_sequences(root) == sorted(seqs)
    for name in seqs:
        got = benchmark.load_benchmark_sequence(os.path.join(root, name), *size)
        want = jax_bench.load_benchmark_sequence(os.path.join(root, name), *size)
        assert got.name == want.name == name
        assert got.frames.shape == want.frames.shape == (len(seqs[name].frames), size[1],
                                                         size[0], 3)
        assert np.abs(got.frames - want.frames).max() <= 1 / 255 + 1e-6
        np.testing.assert_allclose(got.k, want.k, rtol=0, atol=1e-6)
        assert got.gt_depths.dtype == want.gt_depths.dtype == np.float32
        np.testing.assert_array_equal(got.gt_depths, want.gt_depths)
        np.testing.assert_allclose(got.gt_poses, want.gt_poses, rtol=0, atol=1e-12)
    native = benchmark.load_benchmark_sequence(os.path.join(root, "seq_c"), W, H)
    np.testing.assert_allclose(native.gt_poses, seqs["seq_c"].poses, atol=1e-6)
    np.testing.assert_allclose(native.gt_depths, seqs["seq_c"].depths,
                               atol=float(seqs["seq_c"].depths.max()) / 65535)


def test_nearest_resize_equals_cv2():
    d = np.random.default_rng(8).random((64, 96)).astype(np.float32)
    for w, h in ((48, 32), (144, 80), (37, 53), (320, 256)):
        np.testing.assert_array_equal(
            benchmark._nearest_resize(d, w, h),
            cv2.resize(d, (w, h), interpolation=cv2.INTER_NEAREST))


def test_loader_errors_match_reference(tmp_path):
    seq = render_sequence(n_frames=3, height=H, width=W, seed=4)
    _write_sequence(str(tmp_path), "s", seq)
    os.remove(tmp_path / "s" / "depth" / "000001.npy")
    for mod in (benchmark, jax_bench):
        with pytest.raises(FileNotFoundError, match="000001"):
            mod.load_benchmark_sequence(str(tmp_path / "s"), W, H)
    np.savetxt(tmp_path / "s" / "intrinsics.txt", [1.0, 2.0])
    with pytest.raises(ValueError, match="9 or 4"):
        benchmark._load_intrinsics(str(tmp_path / "s" / "intrinsics.txt"), (W, H), (W, H))


_PAIRS = {
    "FrameDirSource.__init__": (sources.FrameDirSource.__init__,
                                jax_sources.FrameDirSource.__init__),
    "VideoFrameSource.__init__": (sources.VideoFrameSource.__init__,
                                  jax_sources.VideoFrameSource.__init__),
    "ArraySource.__init__": (sources.ArraySource.__init__, jax_sources.ArraySource.__init__),
    "open_source": (sources.open_source, jax_sources.open_source),
    "_emit": (sources._emit, jax_sources._emit),
    "_resize": (sources._resize, jax_sources._resize),
    "_to_float_rgb": (sources._to_float_rgb, jax_sources._to_float_rgb),
    "list_sequences": (benchmark.list_sequences, jax_bench.list_sequences),
    "_load_intrinsics": (benchmark._load_intrinsics, jax_bench._load_intrinsics),
    "_quat_to_rot": (benchmark._quat_to_rot, jax_bench._quat_to_rot),
    "_load_poses": (benchmark._load_poses, jax_bench._load_poses),
    "_nearest_resize": (benchmark._nearest_resize, jax_bench._nearest_resize),
    "load_benchmark_sequence": (benchmark.load_benchmark_sequence,
                                jax_bench.load_benchmark_sequence),
    "BenchmarkSequence": (benchmark.BenchmarkSequence, jax_bench.BenchmarkSequence),
}


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_signatures_match_the_reference(name):
    got, want = _PAIRS[name]
    describe = lambda fn: [(p.name, p.kind, p.default)  # noqa: E731
                           for p in inspect.signature(fn).parameters.values()]
    assert describe(got) == describe(want)


def test_quaternion_rotation_matches_reference():
    for q in np.random.default_rng(9).normal(size=(5, 4)):
        np.testing.assert_allclose(benchmark._quat_to_rot(*q), jax_bench._quat_to_rot(*q),
                                   rtol=0, atol=1e-15)
