"""The port's host image layer for real files, held to cv2 and to the JAX
package on the CPU.

Palette PNGs read as `cv2.imread` reads them, colour and gray (VOC's
`SegmentationObject` masks, whose palette colours read as lumas through
IMREAD_GRAYSCALE); `improc.resize` equals `cv2.resize` on every branch of
INTER_AREA and INTER_LINEAR for uint8 and, within 1e-6 relative, for
float32; `resize_by_factor`, `paste_over` and `white_balance` equal the JAX
package's; the VOC occluder and background loaders build the JAX package's
banks from the fixture trees under `tests/fixtures/real_files/` (written by
`tests/fixtures/make_real_files.py`) without cv2; a missing JPEG decoder
raises and never turns into the procedural banks; the JPEG backend is
libjpeg here, and a stub nvJPEG library routes, sizes and refuses as the
real one does. The nvJPEG decode itself is held to the fixtures' libjpeg
pixels on the card (`tests/test_torch_cuda.py`).
"""
import importlib.util
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from metro_pose3d_tpu.pipeline import backgrounds as jax_backgrounds
from metro_pose3d_tpu.pipeline import occluders as jax_occluders
from metro_pose3d_tpu.utils import improc as jax_improc
from metro_pose3d_tpu_torch.native import build as native
from metro_pose3d_tpu_torch.pipeline import backgrounds, occluders
from metro_pose3d_tpu_torch.utils import improc

cv2 = pytest.importorskip("cv2")

REAL = os.path.join(os.path.dirname(__file__), "fixtures", "real_files")
VOC_SEG = os.path.join(REAL, "VOCdevkit", "VOC2012", "SegmentationObject")
JPEG_NAMES = ("s444", "s422", "s420", "gray", "progressive", "restart", "odd_37x53",
              "frame_1000", "mask_1000")
FLOAT_RTOL = 1e-6


# --- palette PNGs ---------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _palette_png(index, palette, trns=None, depth=8, extra=b"", plte=True) -> bytes:
    h, w = index.shape
    raw = b"".join(b"\x00" + index[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 3, 0, 0, 0))
            + extra + (_chunk(b"PLTE", palette.astype(np.uint8).tobytes()) if plte else b"")
            + (_chunk(b"tRNS", bytes(trns)) if trns is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def palette_case():
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (40, 3))
    palette[1], palette[2], palette[3] = (128, 0, 0), (0, 128, 0), (224, 224, 192)
    index = rng.integers(0, 48, (23, 31)).astype(np.uint8)  # some past the palette
    index[0, :4] = (0, 1, 2, 3)
    return index, palette


@pytest.mark.parametrize("trns", [None, "short", "full"])
@pytest.mark.parametrize("gray", [False, True])
def test_palette_png_reads_as_cv2(palette_case, trns, gray):
    index, palette = palette_case
    alpha = {None: None, "short": [255, 128, 0], "full": [7] * 40}[trns]
    data = _palette_png(index, palette, alpha)
    got = improc.decode_png_bytes(data, gray=gray)
    want = cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(got, want if gray else want[..., ::-1])
    if gray:  # VOC's colours 1, 2 and 255 read as 38, 75 and 220
        assert got[0, 1:4].tolist() == [38, 75, 220]


@pytest.mark.parametrize("name", sorted(os.listdir(VOC_SEG)))
def test_voc_masks_read_as_cv2(name):
    path = os.path.join(VOC_SEG, name)
    np.testing.assert_array_equal(improc.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(improc.imread(path), cv2.imread(path)[..., ::-1])


def test_palette_pngs_the_port_does_not_read_raise(palette_case):
    index, palette = palette_case
    with pytest.raises(ValueError, match="mask.png: PNG with a bit depth of 4"):
        improc.decode_png_bytes(_palette_png(index, palette, depth=4), name="mask.png")
    with pytest.raises(improc.CorruptImage, match="without a valid PLTE"):
        improc.decode_png_bytes(_palette_png(index, palette, plte=False), name="mask.png")
    gamma = _chunk(b"gAMA", struct.pack(">I", 45455))
    with pytest.raises(ValueError, match="gamma chunk read as gray"):
        improc.decode_png_bytes(_palette_png(index, palette, extra=gamma), gray=True)
    np.testing.assert_array_equal(  # colour reads ignore the gamma chunk, as cv2's do
        improc.decode_png_bytes(_palette_png(index, palette, extra=gamma)),
        cv2.imdecode(np.frombuffer(_palette_png(index, palette, extra=gamma), np.uint8),
                     cv2.IMREAD_COLOR)[..., ::-1])


# --- resize ---------------------------------------------------------------------

# (source h, w) -> (destination h, w), by the branch of cv2.resize they take
RESIZE_CASES = {
    "area integer 2x2": ("area", (64, 96), (32, 48)),
    "area integer 3x2": ("area", (63, 64), (21, 32)),
    "area non-integer": ("area", (120, 130), (96, 96)),
    "area mixed shrink and grow": ("area", (110, 36), (96, 96)),
    "area grow": ("area", (37, 50), (96, 113)),
    "area to 1 pixel": ("area", (17, 23), (1, 1)),
    "area from 1 pixel": ("area", (1, 1), (5, 7)),
    "linear grow": ("linear", (37, 50), (96, 113)),
    "linear shrink": ("linear", (120, 130), (41, 57)),
    "linear 2x is area": ("linear", (64, 96), (32, 48)),
    "linear one row": ("linear", (1, 40), (3, 77)),
    "linear to 1 pixel": ("linear", (17, 23), (1, 1)),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_equals_cv2(case, channels, dtype):
    interpolation, (sh, sw), (dh, dw) = RESIZE_CASES[case]
    rng = np.random.default_rng(len(case) * 10 + channels)
    shape = (sh, sw) if channels == 1 else (sh, sw, channels)
    if dtype == np.uint8:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        img[: sh // 2] = img[: sh // 2] // 64 * 85  # flat areas: rounding ties
    else:
        img = rng.random(shape).astype(np.float32)
    got = improc.resize(img, (dw, dh), interpolation)
    want = cv2.resize(img, (dw, dh), interpolation={
        "area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[interpolation])
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0)


def test_resize_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="interpolation"):
        improc.resize(np.zeros((4, 4), np.uint8), (2, 2), "cubic")
    for img in (np.zeros((4, 4), np.float64), np.zeros((4, 4, 2), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="1, 3 or 4 channels"):
            improc.resize(img, (2, 2), "area")


@pytest.mark.parametrize("factor", [0.3, 0.5, 0.77, 1.0, 1.6, 2.0])
def test_resize_by_factor_equals_the_jax_package(factor):
    img = np.random.default_rng(3).integers(0, 256, (45, 61, 3)).astype(np.uint8)
    np.testing.assert_array_equal(improc.resize_by_factor(img, factor),
                                  jax_improc.resize_by_factor(img, factor))


@pytest.mark.parametrize("center", [(30, 20), (2, 3), (70, 50), (500, 500)])
def test_paste_over_equals_the_jax_package(center):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (21, 17, 4)).astype(np.uint8)
    dst = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(improc.paste_over(src, dst, center),
                                  jax_improc.paste_over(src, dst, center))


@pytest.mark.parametrize("strength", [0.0, 0.4, 1.0])
def test_white_balance_equals_the_jax_package(strength):
    img = np.random.default_rng(5).integers(0, 256, (33, 41, 3)).astype(np.uint8)
    np.testing.assert_array_equal(improc.white_balance(img, strength),
                                  jax_improc.white_balance(img, strength))


# --- the fixtures' libjpeg pixels -------------------------------------------------

@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("name", JPEG_NAMES)
def test_fixture_pixels_are_libjpegs_and_cv2s(name, gray):
    path = os.path.join(REAL, "jpeg", f"{name}.jpg")
    stored = improc.imread(os.path.join(REAL, "jpeg", f"{name}.{'gray' if gray else 'rgb'}.png"))
    got = improc.imread_gray(path) if gray else improc.imread(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE) if gray else cv2.imread(path)[..., ::-1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stored[..., 0] if gray else stored, got)


# --- the banks --------------------------------------------------------------------

def test_voc_occluders_equal_the_jax_package():
    """6 tiles: in 2008_000001 the objects of lumas 38 (36 x 110: cv2's
    linear branch), 75 (shrinks) and the void outline (220), not 113 (under
    500 pixels); in 2008_000002 luma 14 (192 x 192: the integer area path),
    not 52 (touches the border) nor its outline (touches it too); in
    2008_000005 luma 19 and the outline; 2008_000003 has no JPEG and
    2008_000004's is not one."""
    got = occluders.load_voc_occluders(REAL)
    want = jax_occluders.load_voc_occluders(REAL)
    assert got.shape == want.shape == (6, 96, 96, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0)
    assert np.array_equal(got, want)  # equal in fact: no float linear branch here
    lumas = {np.unique(improc.imread_gray(os.path.join(VOC_SEG, f))).tolist()[-1]
             for f in ("2008_000001.png", "2008_000005.png")}
    assert lumas == {220}  # the outline is one more gray level, kept
    small = occluders.load_voc_occluders(REAL, tile_side=24, max_count=4)
    np.testing.assert_array_equal(small, jax_occluders.load_voc_occluders(REAL, 24, 4))


@pytest.mark.parametrize("side", [512, 96])
def test_backgrounds_equal_the_jax_package(side):
    path = os.path.join(REAL, "backgrounds")
    got = backgrounds.load_backgrounds_from_dir(path, side)
    assert got.shape == (4, side, side, 3)
    np.testing.assert_array_equal(got, jax_backgrounds.load_backgrounds_from_dir(path, side))


def test_the_card_check_holds_the_banks_built_here():
    """chip_smoke.py phase 22 holds the banks that the card's host builds from
    the stored libjpeg pixels to these tile counts and digests."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_for_banks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with smoke.libjpeg_pixels(improc):
        banks = {"voc": occluders.load_voc_occluders(REAL),
                 "backgrounds": backgrounds.load_backgrounds_from_dir(os.path.join(REAL, "backgrounds"))}
    for what, bank in banks.items():
        assert (len(bank), smoke.bank_digest(bank)) == smoke.REAL_BANKS[what], what


@pytest.fixture
def no_jpeg_decoder(monkeypatch):
    """libjpeg's build failed and nvJPEG has no library: no JPEG decoder."""
    monkeypatch.setattr(improc, "_backend", None)
    monkeypatch.setitem(native._loaded, "jpegdec", "fatal error: jpeglib.h: no such file")
    monkeypatch.setitem(native._loaded, "nvjpegdec", "nvcc not found")


def test_without_a_decoder_the_banks_raise(no_jpeg_decoder):
    with pytest.raises(improc.NoJpegDecoder, match="libjpeg.*nvJPEG"):
        occluders.get_occluder_bank(REAL, tile_side=24)
    with pytest.raises(improc.NoJpegDecoder):
        backgrounds.get_background_bank(os.path.join(REAL, "backgrounds"), side=32)


def test_only_a_missing_tree_or_no_usable_object_falls_back(tmp_path):
    procedural = occluders.make_procedural_occluders(tile_side=24)
    np.testing.assert_array_equal(occluders.get_occluder_bank(str(tmp_path), 24), procedural)
    seg = tmp_path / "VOCdevkit" / "VOC2012" / "SegmentationObject"
    seg.mkdir(parents=True)
    (seg / "a.png").write_bytes(_palette_png(np.zeros((8, 8), np.uint8), np.zeros((2, 3))))
    with pytest.raises(occluders.NoUsableOccluders):
        occluders.load_voc_occluders(str(tmp_path))
    np.testing.assert_array_equal(occluders.get_occluder_bank(str(tmp_path), 24), procedural)
    np.testing.assert_array_equal(backgrounds.get_background_bank(str(tmp_path), 32),
                                  backgrounds.make_procedural_backgrounds(side=32))


# --- the JPEG backend ---------------------------------------------------------------

def test_backend_here_is_libjpeg():
    assert improc.jpeg_backend() == "libjpeg"


def test_without_libjpeg_or_cuda_the_read_names_both(no_jpeg_decoder):
    with pytest.raises(improc.NoJpegDecoder, match="(?s)jpeglib.h.*nvJPEG: .*nvcc not found"):
        improc.imread(os.path.join(REAL, "jpeg", "s420.jpg"))


class _StubNvjpeg:
    """The nvJPEG library's C interface, with libjpeg underneath: decodes
    as libjpeg does, refuses what libjpeg refuses (code 1), and counts."""

    def __init__(self, init_code=0):
        self.init_code, self.calls = init_code, []
        self.libjpeg = native.load("jpegdec")

    def metro_nvjpeg_init(self):
        self.calls.append("init")
        return self.init_code

    def metro_nvjpeg_dims(self, data, n, h, w, components):
        self.calls.append("dims")
        if self.libjpeg.metro_jpeg_dims(data, n, h, w):
            return native.NVJPEG_REFUSED
        components._obj.value = 3
        return 0

    def metro_nvjpeg_decode(self, data, n, out, h, w, gray):
        self.calls.append("gray" if gray else "rgb")
        decode = self.libjpeg.metro_decode_jpeg_gray if gray else self.libjpeg.metro_decode_jpeg
        return native.NVJPEG_REFUSED if decode(data, n, out, h, w) else 0


@pytest.fixture
def stub_nvjpeg(monkeypatch):
    stub = _StubNvjpeg()
    monkeypatch.setattr(improc, "_backend", None)
    monkeypatch.setitem(native._loaded, "jpegdec", "fatal error: jpeglib.h: no such file")
    monkeypatch.setitem(native._loaded, "nvjpegdec", stub)
    return stub


def test_stub_nvjpeg_routes_sizes_and_refuses(stub_nvjpeg):
    path = os.path.join(REAL, "jpeg", "odd_37x53.jpg")
    with open(path, "rb") as f:
        data = f.read()
    assert improc.jpeg_backend() == "nvjpeg"
    got = improc.imread(path)
    assert got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, improc.imread(path[:-4] + ".rgb.png"))
    np.testing.assert_array_equal(improc.imread_gray(path),
                                  improc.imread(path[:-4] + ".gray.png")[..., 0])
    assert stub_nvjpeg.calls == ["init", "dims", "rgb", "dims", "gray"]
    with pytest.raises(improc.CorruptImage, match="nvJPEG refused"):
        improc.decode_jpeg_bytes(b"definitely not a jpeg")
    with pytest.raises(ValueError, match="item 1"):
        improc.decode_jpeg_batch([data, b"not a jpeg", data], threads=2)
    outs = improc.decode_jpeg_batch([data] * 3, threads=2)
    assert all(np.array_equal(o, got) for o in outs)
    stub_nvjpeg.metro_nvjpeg_decode = lambda *a: native.NVJPEG_CUDA_FAULT + 2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        improc.decode_jpeg_bytes(data)


def test_stub_nvjpeg_without_a_device_is_no_decoder(monkeypatch):
    stub = _StubNvjpeg(init_code=native.NVJPEG_NO_DEVICE)
    monkeypatch.setattr(improc, "_backend", None)
    monkeypatch.setitem(native._loaded, "jpegdec", "fatal error: jpeglib.h: no such file")
    monkeypatch.setitem(native._loaded, "nvjpegdec", stub)
    with pytest.raises(improc.NoJpegDecoder, match="no CUDA device"):
        improc.jpeg_backend()
    with pytest.raises(improc.NoJpegDecoder):
        occluders.get_occluder_bank(REAL, tile_side=24)


def test_image_modules_import_neither_cv2_nor_torch():
    code = ("import sys; import metro_pose3d_tpu_torch.utils.improc, "
            "metro_pose3d_tpu_torch.pipeline.occluders, metro_pose3d_tpu_torch.pipeline.backgrounds; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'cv2', 'torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
