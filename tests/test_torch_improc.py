"""The port's host image runtime (`metro_pose3d_tpu_torch/utils/improc.py`,
`native/jpegdec.c`, `native/croprep.c`) against the JAX package's
(`metro_pose3d_tpu/utils/improc.py` and its `_metro_native` extension).

JPEG decoding: the same libjpeg, so the port's decode equals the JAX
package's native decode bit for bit on cv2-encoded bytes. Where libjpeg is
missing the port raises and names it (there is no cv2 fallback).
`tests/fixtures/rgb_48x64.jpg` is a seeded 48x64 image that cv2 encoded at
quality 90; `rgb_48x64_pixels.npz` holds what the JAX package's native
decoder gave for it. Tile copy: the port's C and numpy versions equal the
JAX package's bit for bit, thin-edge regions and grey masks included.
"""
import os

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
        img = np.random.default_rng(3).integers(0, 255, (20, 30, 3)).astype(np.uint8)
        p = str(tmp_path / "x.png")
        assert cv2.imwrite(p, img[..., ::-1])
        np.testing.assert_array_equal(improc.imread(p), img)
        with pytest.raises(FileNotFoundError):
            improc.imread(str(tmp_path / "missing.png"))

    def test_without_libjpeg_a_jpeg_read_raises_and_names_it(self, monkeypatch, jpeg_bytes,
                                                             tmp_path):
        """A failed build of the decoder (no jpeglib.h or -ljpeg) is
        remembered; reading a JPEG then raises and names libjpeg, while the
        crop engine, which needs no libjpeg, keeps working."""
        monkeypatch.setitem(native._loaded, "jpegdec", "fatal error: jpeglib.h: no such file")
        with pytest.raises(RuntimeError, match="libjpeg"):
            improc.decode_jpeg_bytes(jpeg_bytes)
        p = tmp_path / "x.jpg"
        p.write_bytes(jpeg_bytes)
        with pytest.raises(RuntimeError, match="jpeglib.h"):
            improc.imread(str(p))
        assert improc.have_native()


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
