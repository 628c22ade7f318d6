"""The port's host image runtime (`metro_pose3d_tpu_torch/utils/improc.py`,
`native/jpegdec.c`, `native/croprep.c`) against the JAX package's
(`metro_pose3d_tpu/utils/improc.py` and its `_metro_native` extension).

JPEG decoding: the same libjpeg, so the port's decode equals the JAX
package's native decode bit for bit on cv2-encoded bytes. Where libjpeg is
missing the port raises and names it (there is no cv2 fallback).
`tests/fixtures/rgb_48x64.jpg` is a seeded 48x64 image that cv2 encoded at
quality 90; `rgb_48x64_pixels.npz` holds what the JAX package's native
decoder gave for it. The grayscale JPEG decode (masks) equals cv2's
IMREAD_GRAYSCALE on 1- and 3-component JPEGs: cv2's bundled libjpeg and the
system one give the same luma here, so no pixel differs. PNG: the port's
reader (zlib, then `native/pngdec.c`'s row unfilter) equals `cv2.imread` on
the PNGs cv2 writes and reads every row filter of a test-local encoder; it
raises on the PNGs it does not read. Tile copy: the port's C and numpy
versions equal the JAX package's bit for bit, thin-edge regions and grey
masks included.
"""
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from metro_pose3d_tpu.utils import improc as jax_improc
from metro_pose3d_tpu_torch.native import build as native
from metro_pose3d_tpu_torch.utils import improc

cv2 = pytest.importorskip("cv2")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def jpeg_bytes():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92])
    assert ok
    return enc.tobytes()


def _jax_native_decode(data):
    if not jax_improc.have_native():
        pytest.skip("the JAX package's native extension did not build here")
    return jax_improc.decode_jpeg_bytes(data)


class TestDecode:
    def test_matches_jax_native_and_cv2(self, jpeg_bytes):
        got = improc.decode_jpeg_bytes(jpeg_bytes)
        assert got.shape == (240, 320, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _jax_native_decode(jpeg_bytes))
        want = cv2.imdecode(np.frombuffer(jpeg_bytes, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(got, want)  # the same libjpeg underneath

    def test_fixture_pixels(self):
        with open(os.path.join(FIXTURES, "rgb_48x64.jpg"), "rb") as f:
            data = f.read()
        want = np.load(os.path.join(FIXTURES, "rgb_48x64_pixels.npz"))["rgb"]
        np.testing.assert_array_equal(improc.decode_jpeg_bytes(data), want)
        np.testing.assert_array_equal(improc.imread(os.path.join(FIXTURES, "rgb_48x64.jpg")),
                                      want)

    def test_batch(self, jpeg_bytes):
        with open(os.path.join(FIXTURES, "rgb_48x64.jpg"), "rb") as f:
            small = f.read()
        items = [jpeg_bytes, small] * 4 + [jpeg_bytes]
        outs = improc.decode_jpeg_batch(items, threads=3)
        assert len(outs) == 9
        for data, o in zip(items, outs):
            np.testing.assert_array_equal(o, improc.decode_jpeg_bytes(data))

    def test_corrupt_raises(self, jpeg_bytes):
        with pytest.raises(ValueError):
            improc.decode_jpeg_bytes(b"definitely not a jpeg")
        with pytest.raises(ValueError, match="item 1"):
            improc.decode_jpeg_batch([jpeg_bytes, b"not a jpeg"])

    def test_empty_batch(self):
        assert improc.decode_jpeg_batch([]) == []

    def test_imread_roundtrip(self, tmp_path, jpeg_bytes):
        p = tmp_path / "x.jpg"
        p.write_bytes(jpeg_bytes)
        np.testing.assert_array_equal(improc.imread(str(p)), jax_improc.imread(str(p)))
        with pytest.raises((FileNotFoundError, ValueError)):
            improc.imread(str(tmp_path / "missing.jpg"))

    def test_imread_png_through_cv2(self, tmp_path):
        """A PNG that cv2 writes reads back as its RGB pixels (through the
        port's own PNG reader, no longer through cv2)."""
        img = np.random.default_rng(3).integers(0, 255, (20, 30, 3)).astype(np.uint8)
        p = str(tmp_path / "x.png")
        assert cv2.imwrite(p, img[..., ::-1])
        np.testing.assert_array_equal(improc.imread(p), img)
        with pytest.raises(FileNotFoundError):
            improc.imread(str(tmp_path / "missing.png"))

    @pytest.mark.parametrize("components", [1, 3])
    def test_gray_jpeg_equals_cv2(self, tmp_path, components):
        rng = np.random.default_rng(components)
        img = rng.integers(0, 256, (37, 45) if components == 1 else (37, 45, 3)).astype(np.uint8)
        img[5:20, 10:30] = 255  # a mask-like flat block
        p = str(tmp_path / "m.jpg")
        assert cv2.imwrite(p, img)
        got = improc.imread_gray(p)
        assert got.shape == (37, 45) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))


    def test_without_libjpeg_a_jpeg_read_raises_and_names_it(self, monkeypatch, jpeg_bytes,
                                                             tmp_path):
        """A failed build of the decoder (no jpeglib.h or -ljpeg) is
        remembered; where nvJPEG cannot stand in either (here: no nvcc, no
        card), reading a JPEG then raises and names libjpeg and nvJPEG,
        while the crop engine, which needs no libjpeg, keeps working."""
        monkeypatch.setattr(improc, "_backend", None)  # choose the backend again
        monkeypatch.setitem(native._loaded, "jpegdec", "fatal error: jpeglib.h: no such file")
        monkeypatch.setitem(native._loaded, "nvjpegdec", "nvcc not found")
        with pytest.raises(RuntimeError, match="(?s)libjpeg.*nvJPEG"):
            improc.decode_jpeg_bytes(jpeg_bytes)
        p = tmp_path / "x.jpg"
        p.write_bytes(jpeg_bytes)
        with pytest.raises(RuntimeError, match="jpeglib.h"):
            improc.imread(str(p))
        assert improc.have_native()


# --- PNG ------------------------------------------------------------------------

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filters, color_type=None, depth=8, interlace=0,
               palette=None) -> bytes:
    """A plain PNG encoder: row y gets filter `filters[y % len(filters)]`."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        corner = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        f = filters[y % len(filters)]
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, corner)][f]
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += _png_chunk(b"PLTE", bytes(palette))
    # two IDAT chunks, as encoders may split the stream anywhere
    data = zlib.compress(bytes(raw), 6)
    return out + _png_chunk(b"IDAT", data[:7]) + _png_chunk(b"IDAT", data[7:]) + \
        _png_chunk(b"IEND", b"")


PNG_SHAPES = [(1, 1), (1, 1, 3), (13, 7), (20, 31, 3), (9, 17, 4), (40, 33, 4), (6, 1, 3)]


@pytest.mark.parametrize("shape", PNG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_png_equals_cv2(tmp_path, shape):
    """PNGs that cv2 writes (gray, RGB, RGBA, odd widths, 1x1; noise and
    smooth ramps, so that cv2's encoder picks filters other than None)."""
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256
    ramp = np.broadcast_to(ramp[..., None] if len(shape) == 3 else ramp, shape)
    for img in (rng.integers(0, 256, shape), ramp):
        img = np.ascontiguousarray(img, np.uint8)
        p = str(tmp_path / "x.png")
        assert cv2.imwrite(p, img)
        got = improc.imread(p)
        assert got.shape == (*shape[:2], 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, cv2.imread(p)[..., ::-1])
        if len(shape) == 2:
            np.testing.assert_array_equal(improc.imread_gray(p),
                                          cv2.imread(p, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("shape", PNG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_png_writer_round_trips_and_cv2_reads_it(tmp_path, shape):
    """`imwrite_png` (zlib alone, the demo's writer) -> the port's reader
    and cv2's give back the pixels: gray replicated, alpha dropped."""
    img = np.random.default_rng(shape[0] * 7 + len(shape)).integers(0, 256, shape, np.uint8)
    p = improc.imwrite_png(str(tmp_path / "w.png"), img)
    rgb = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
    np.testing.assert_array_equal(improc.imread(p), rgb)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED),
                                  img if img.ndim == 2 else cv2.cvtColor(
                                      img, cv2.COLOR_RGB2BGR if shape[2] == 3
                                      else cv2.COLOR_RGBA2BGRA))
    if img.ndim == 2:
        np.testing.assert_array_equal(improc.imread_gray(p), img)


def test_png_writer_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint16), np.zeros((4, 4, 2), np.uint8),
                np.zeros(4, np.uint8)):
        with pytest.raises(ValueError, match="encode_png takes uint8"):
            improc.encode_png(bad)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_every_row_filter(tmp_path, filters, channels):
    rng = np.random.default_rng(channels)
    shape = (11, 19) if channels == 1 else (11, 19, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(encode_png(img, filters))
    want = cv2.imread(str(p))[..., ::-1]
    got = improc.imread(str(p))
    np.testing.assert_array_equal(got, want)
    rgb = img if channels == 3 else img[..., :3] if channels == 4 else \
        np.repeat(img[..., None], 3, -1)
    np.testing.assert_array_equal(got, rgb)


def test_png_it_does_not_read_raises_naming_the_file(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    assert cv2.imwrite(str(tmp_path / "deep.png"), np.full((4, 5, 3), 4000, np.uint16))
    # a 4-bit palette PNG: 5 pixels a row in 3 bytes
    palette4 = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 4, 3, 0, 0, 0))
                + _png_chunk(b"PLTE", bytes(range(48)))
                + _png_chunk(b"IDAT", zlib.compress((b"\x00" + bytes(3)) * 4))
                + _png_chunk(b"IEND", b""))
    files = {"palette4.png": palette4,
             "adam7.png": encode_png(img, [0], interlace=1),
             "grayalpha.png": encode_png(img[..., :2], [0]),
             "notpng.png": b"GIF89a"}
    # 4 rows of a filter byte + 15 samples; the first row's filter is 5
    rows = b"\x05" + bytes(15) + (b"\x00" + bytes(15)) * 3
    files["filter5.png"] = (encode_png(img, [0])[:33] + _png_chunk(b"IDAT", zlib.compress(rows))
                            + _png_chunk(b"IEND", b""))
    files["short.png"] = (encode_png(img, [0])[:33]
                          + _png_chunk(b"IDAT", zlib.compress(bytes(40)))
                          + _png_chunk(b"IEND", b""))
    crc = bytearray(encode_png(img, [0]))
    crc[-20] ^= 1  # a flipped bit in the image data: the CRC no longer holds
    files["crc.png"] = bytes(crc)
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    expect = {"deep.png": "bit depth of 16", "palette4.png": "bit depth of 4",
              "adam7.png": "interlacing", "grayalpha.png": "colour type 4",
              "notpng.png": "not a PNG",
              "filter5.png": "row filter above 4", "crc.png": "bad CRC",
              "short.png": "40 bytes of PNG data for 4x5x3"}
    damaged = {"filter5.png", "crc.png", "short.png"}
    for name, match in expect.items():
        with pytest.raises(ValueError, match=match) as err:
            improc.imread(str(tmp_path / name))
        assert name in str(err.value)
        # cv2.imread gives None for the damaged files and reads none of the others
        assert isinstance(err.value, improc.CorruptImage) == (name in damaged), name
    # an 8-bit palette PNG reads, as cv2 reads it
    (tmp_path / "palette.png").write_bytes(
        encode_png(np.arange(20, dtype=np.uint8).reshape(4, 5), [0], color_type=3,
                   palette=range(48)))
    np.testing.assert_array_equal(improc.imread(str(tmp_path / "palette.png")),
                                  cv2.imread(str(tmp_path / "palette.png"))[..., ::-1])
    np.testing.assert_array_equal(improc.imread_gray(str(tmp_path / "palette.png")),
                                  cv2.imread(str(tmp_path / "palette.png"), cv2.IMREAD_GRAYSCALE))
    # a colour PNG under a gamma chunk: libpng's gray goes through gamma tables
    for kind, body in ((b"sRGB", b"\x00"), (b"gAMA", struct.pack(">I", 45455))):
        png = encode_png(img, [0])
        (tmp_path / "gamma.png").write_bytes(png[:33] + _png_chunk(kind, body) + png[33:])
        with pytest.raises(ValueError, match="gamma chunk") as err:
            improc.imread_gray(str(tmp_path / "gamma.png"))
        assert "gamma.png" in str(err.value)
        assert not isinstance(err.value, improc.CorruptImage)
        np.testing.assert_array_equal(improc.imread(str(tmp_path / "gamma.png")), img)


@pytest.mark.parametrize("chunk", [None, (b"gAMA", struct.pack(">I", 100000)),
                                   (b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000,
                                                         30000, 60000, 15000, 6000))],
                         ids=["plain", "unit_gamma", "chrm"])
@pytest.mark.parametrize("channels", [3, 4])
def test_colour_png_as_gray_equals_cv2(tmp_path, channels, chunk):
    """A colour PNG read as gray (a mask) is cv2's IMREAD_GRAYSCALE: libpng's
    luma, alpha dropped; chunks that leave libpng's gray as it is."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (96, 97, channels)).astype(np.uint8)
    img[::3, :, 1:3] = img[::3, :, :1]  # gray pixels in a colour file
    p = tmp_path / "c.png"
    assert cv2.imwrite(str(p), img)
    if chunk is not None:
        png = p.read_bytes()
        p.write_bytes(png[:33] + _png_chunk(*chunk) + png[33:])
    want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    got = improc.imread_gray(str(p))
    assert got.dtype == np.uint8 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)


def test_png_and_gray_jpeg_reads_import_no_cv2(tmp_path):
    """A PNG frame and a JPEG mask read without cv2 (the card's machine has
    none): in a fresh interpreter, cv2 stays unimported."""
    rgb = np.random.default_rng(0).integers(0, 256, (8, 9, 3)).astype(np.uint8)
    (tmp_path / "f.png").write_bytes(encode_png(rgb, [4, 1]))
    assert cv2.imwrite(str(tmp_path / "m.jpg"), np.full((8, 9), 200, np.uint8))
    code = ("import sys\n"
            "from metro_pose3d_tpu_torch.utils import improc\n"
            f"a = improc.imread({str(tmp_path / 'f.png')!r})\n"
            f"m = improc.imread_gray({str(tmp_path / 'm.jpg')!r})\n"
            "assert a.shape == (8, 9, 3) and m.shape == (8, 9), (a.shape, m.shape)\n"
            "sys.exit(1 if 'cv2' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    repo = os.path.dirname(os.path.dirname(FIXTURES))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

def test_build_is_atomic_and_keyed_by_source(tmp_path, monkeypatch):
    """The library is compiled into a temporary directory and renamed into
    `build/native/<hash>/`; a second build of the same source reuses it."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    path = native.build("croprep")
    assert path.exists() and path.parent.parent == tmp_path
    assert os.listdir(path.parent) == [path.name]  # no temporary left behind
    assert native.build_seconds["croprep"] > 0
    assert native.build("croprep") == path and native.build_seconds["croprep"] == 0.0
    monkeypatch.setenv("CC", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build("croprep")


class TestExtractTile:
    @staticmethod
    def _jax_numpy_tile(*args):
        saved = jax_improc._native
        jax_improc._native = None
        try:
            return jax_improc.extract_tile_native(*args)
        finally:
            jax_improc._native = saved

    def _check(self, *args):
        want = self._jax_numpy_tile(*args)
        np.testing.assert_array_equal(improc.extract_tile_numpy(*args), want)
        assert improc.have_native()
        np.testing.assert_array_equal(improc.extract_tile_native(*args), want)
        return want

    @pytest.mark.parametrize("factor", [1, 2, 3])
    def test_native_and_numpy_match_jax(self, factor):
        rng = np.random.default_rng(factor)
        img = rng.integers(0, 255, (200, 300, 3)).astype(np.uint8)
        self._check(img, 11, 23, 290, 190, factor, 96)

    def test_zero_pad_and_bounds(self):
        img = np.full((50, 60, 3), 200, np.uint8)
        tile = self._check(img, 0, 0, 60, 50, 1, 128)
        assert tile.shape == (128, 128, 3)
        assert np.all(tile[:50, :60] == 200)
        assert np.all(tile[50:] == 0) and np.all(tile[:, 60:] == 0)

    @pytest.mark.parametrize(
        "roi",
        [
            (56, 46, 60, 50),   # 4x4 ROI touching the bottom-right corner
            (0, 47, 60, 50),    # 3-row strip on the bottom edge (y-partial)
            (58, 0, 60, 50),    # 2-col strip on the right edge (x-partial)
            (59, 49, 60, 50),   # single pixel in the corner
            (10, 44, 58, 50),   # y-partial but x covers full blocks
        ],
    )
    @pytest.mark.parametrize("factor", [6, 20])  # the 3-pass and the plain C loops
    def test_thin_edge_roi_partial_blocks(self, roi, factor):
        """A ROI dimension thinner than `factor` gives one output row/col that
        averages only the pixels inside the ROI."""
        rng = np.random.default_rng(factor)
        img = rng.integers(0, 255, (50, 60, 3)).astype(np.uint8)
        x0, y0, x1, y1 = roi
        tile = self._check(img, x0, y0, x1, y1, factor, 16)
        by, bx = min(factor, y1 - y0), min(factor, x1 - x0)
        blk = img[y0:y0 + by, x0:x0 + bx].astype(np.uint32)
        want = (blk.sum((0, 1)) + by * bx // 2) // (by * bx)
        np.testing.assert_array_equal(tile[0, 0], want.astype(np.uint8))

    @pytest.mark.parametrize("args", [(57, 47, 60, 50, 8, 16), (0, 0, 60, 50, 3, 16),
                                      (5, 5, 45, 40, 1, 32)])
    def test_gray_mask(self, args):
        img = np.random.default_rng(7).integers(0, 255, (50, 60)).astype(np.uint8)
        tile = self._check(img, *args)
        assert tile.shape == (args[-1], args[-1])

    def test_bad_roi_raises(self):
        img = np.zeros((10, 10, 3), np.uint8)
        with pytest.raises(ValueError, match="bad ROI"):
            improc.extract_tile_native(img, 0, 0, 11, 10, 1, 8)


class TestFrameCache:
    def test_lru_budget_hits_and_read_only(self, tmp_path):
        with open(os.path.join(FIXTURES, "rgb_48x64.jpg"), "rb") as f:
            data = f.read()
        paths = []
        for i in range(3):
            p = tmp_path / f"f{i}.jpg"
            p.write_bytes(data)
            paths.append(str(p))
        cache = improc._FrameCache(budget_mb=1)
        cache._budget = 2 * 48 * 64 * 3  # room for two frames
        a = cache.get(paths[0])
        assert cache.get(paths[0]) is a and (cache.hits, cache.misses) == (1, 1)
        with pytest.raises(ValueError):
            a[0, 0, 0] = 1  # cached frames are read-only
        cache.get(paths[1])
        cache.get(paths[2])  # evicts the least recently used: paths[0]
        assert list(cache._entries) == paths[1:]
        cache.clear()
        assert not cache._entries and cache._bytes == 0
        np.testing.assert_array_equal(improc.imread_cached(paths[0]),
                                      improc.decode_jpeg_bytes(data))
