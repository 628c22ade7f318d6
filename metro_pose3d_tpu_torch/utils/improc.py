"""Host image processing: JPEG and PNG reads, a decoded-frame cache,
source-tile copy (`metro_pose3d_tpu/utils/improc.py`; the port keeps its own
copy).

JPEG decoding goes through the port's C decoder against the system libjpeg
(`native/jpegdec.c`); where libjpeg is missing it raises and says so: there
is no cv2 fallback. PNGs are read without cv2: Python's zlib inflates and
`native/pngdec.c` undoes the row filters. It takes 8-bit, non-interlaced
gray, RGB and RGBA files, and gives the pixels `cv2.imread` gives: gray
replicated, alpha dropped. Other PNGs (16-bit, palette, gray + alpha,
interlaced) raise, naming the file. Other image formats go
through cv2, imported inside `imread`. `imread_gray` reads an image as
`cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does, for masks: a colour PNG
becomes libpng's luma. Files that are damaged raise `CorruptImage`, where
cv2.imread gives None; files of a kind the port does not read raise a plain
ValueError. The tile
copy runs in C (`native/croprep.c`) where the compiler builds it, in numpy
otherwise; both give the same bytes. Everything returns uint8 numpy arrays,
RGB where they have colour. This module imports neither torch nor cv2.
"""
from __future__ import annotations

import collections
import ctypes
import struct
import threading
import zlib

import numpy as np

from metro_pose3d_tpu_torch.native import build as native


def have_native() -> bool:
    """Whether the C tile copy and crop engine built on this machine."""
    return native.crop_library() is not None


class CorruptImage(ValueError):
    """A damaged image file: one that cv2.imread would give None for."""


def _jpeg_dims(lib, data: bytes) -> tuple:
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.metro_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w)):
        raise CorruptImage("corrupt or unsupported JPEG")
    return h.value, w.value


def decode_jpeg_bytes(data: bytes, gray: bool = False) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3], or with `gray` the luma [H, W] as
    libjpeg gives it (cv2's IMREAD_GRAYSCALE); CorruptImage if libjpeg
    refuses them."""
    lib = native.jpeg_library()
    data = bytes(data)
    h, w = _jpeg_dims(lib, data)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    decode = lib.metro_decode_jpeg_gray if gray else lib.metro_decode_jpeg
    if decode(data, len(data), out.ctypes.data, h, w):
        raise CorruptImage("corrupt or unsupported JPEG")
    return out


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel (0 gray, 2 RGB, 6 RGBA); 3 (palette) and
# 4 (gray + alpha) are not read
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
# libpng's rgb_to_gray weights for cv2's (0.299, 0.587), at 15 bits
_LUMA15 = np.array([9797, 19234, 3737], np.uint32)
# chunks after which libpng's rgb_to_gray works through gamma tables
_PNG_GAMMA_CHUNKS = (b"sRGB", b"iCCP")
_PNG_UNIT_GAMMA = struct.pack(">I", 100000)


def decode_png_bytes(data: bytes, gray: bool = False, name: str = "PNG") -> np.ndarray:
    """PNG bytes -> RGB uint8 [H, W, 3] (gray replicated, alpha dropped, as
    cv2.imread's IMREAD_COLOR), or with `gray` uint8 [H, W] as
    IMREAD_GRAYSCALE gives it (a colour PNG's luma as libpng computes it).
    Errors name `name`: CorruptImage for a damaged file (truncated, a bad
    CRC, length or row filter, corrupt data); ValueError for one it does not
    read (not a PNG, a bit depth other than 8, a palette, gray + alpha,
    interlacing, or colour with `gray` under a gamma chunk)."""
    data = bytes(data)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    header, idat, pos, gamma = None, [], 8, False
    while True:
        if pos + 8 > len(data):
            raise CorruptImage(f"{name}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise CorruptImage(f"{name}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise CorruptImage(f"{name}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise CorruptImage(f"{name}: a PNG header of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind in _PNG_GAMMA_CHUNKS or (kind == b"gAMA" and body != _PNG_UNIT_GAMMA):
            gamma = True
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise CorruptImage(f"{name}: PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or compression or filtering or interlace:
        what = ("a bit depth of %d" % depth if depth != 8
                else "a palette" if color == 3
                else "Adam7 interlacing" if interlace
                else f"colour type {color}, compression {compression}, filter {filtering}")
        raise ValueError(f"{name}: PNG with {what}; the port reads 8-bit, non-interlaced "
                         "gray, RGB and RGBA PNGs")
    ch = _PNG_CHANNELS[color]
    if gray and ch > 1 and gamma:
        raise ValueError(f"{name}: a colour PNG with a gamma chunk read as gray; the port "
                         "reads colour PNGs as gray only without gAMA, sRGB or iCCP")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"{name}: corrupt PNG data ({e})") from None
    if len(raw) != h * (1 + w * ch):
        raise CorruptImage(f"{name}: {len(raw)} bytes of PNG data for {h}x{w}x{ch}")
    out = np.empty((h, w, ch), np.uint8)
    if native.png_library().metro_png_unfilter(raw, len(raw), h, w, ch, out.ctypes.data):
        raise CorruptImage(f"{name}: a PNG row filter above 4")
    if ch == 1:
        return out.reshape(h, w) if gray else np.repeat(out, 3, axis=-1)
    if gray:
        return ((out[..., :3] @ _LUMA15) >> 15).astype(np.uint8)
    return out if ch == 3 else np.ascontiguousarray(out[..., :3])


def decode_jpeg_batch(items, threads: int = 4) -> list:
    """list[bytes] -> list[RGB uint8 array], decoded on `threads` threads in
    C; ValueError naming the first item libjpeg refuses."""
    items = [bytes(d) for d in items]
    if not items:
        return []
    lib = native.jpeg_library()
    n = len(items)
    dims = []
    for i, d in enumerate(items):
        try:
            dims.append(_jpeg_dims(lib, d))
        except ValueError as e:
            raise ValueError(f"item {i}: {e}") from None
    outs = [np.empty((h, w, 3), np.uint8) for h, w in dims]
    datas = (ctypes.c_char_p * n)(*items)
    lens = (ctypes.c_size_t * n)(*(len(d) for d in items))
    ptrs = (ctypes.c_void_p * n)(*(o.ctypes.data for o in outs))
    hs = (ctypes.c_int * n)(*(h for h, _ in dims))
    ws = (ctypes.c_int * n)(*(w for _, w in dims))
    status = (ctypes.c_int * n)()
    lib.metro_decode_jpeg_batch(datas, lens, ptrs, hs, ws, n, int(threads), status)
    for i, s in enumerate(status):
        if s:
            raise ValueError(f"item {i}: corrupt or unsupported JPEG")
    return outs


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def imread(path: str) -> np.ndarray:
    """Image file -> RGB uint8; JPEG through the C decoder, PNG through
    `decode_png_bytes`, other formats through cv2 (imported here, only for
    them)."""
    lower = str(path).lower()
    if lower.endswith((".jpg", ".jpeg")):
        return decode_jpeg_bytes(_read_bytes(path))
    if lower.endswith(".png"):
        return decode_png_bytes(_read_bytes(path), name=str(path))
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(img[..., ::-1])


def imread_gray(path: str) -> np.ndarray:
    """Image file (a mask) -> uint8 [H, W], as
    `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives it: a JPEG's luma through
    the C decoder, a PNG through `decode_png_bytes`; ValueError for other
    formats."""
    lower = str(path).lower()
    if lower.endswith((".jpg", ".jpeg")):
        return decode_jpeg_bytes(_read_bytes(path), gray=True)
    if lower.endswith(".png"):
        return decode_png_bytes(_read_bytes(path), gray=True, name=str(path))
    raise ValueError(f"{path}: the port reads masks from JPEG and PNG files only")


class _FrameCache:
    """Thread-safe byte-budgeted LRU of decoded frames, keyed by path.

    The loader's worker threads share it (one process-wide dict serves them
    all), so frames that several crops or epochs reuse are decoded once.
    Entries are read-only: `prepare_example` never writes its source frame,
    and an accidental in-place edit raises instead of corrupting every later
    crop of the frame.
    """

    def __init__(self, budget_mb: int = 2048):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()
        self._bytes = 0
        self._budget = budget_mb * (1 << 20)
        self.hits = 0
        self.misses = 0

    def set_budget_mb(self, budget_mb: int):
        with self._lock:
            self._budget = budget_mb * (1 << 20)
            self._evict()

    def _evict(self):
        while self._bytes > self._budget and self._entries:
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes

    def get(self, path: str) -> np.ndarray:
        with self._lock:
            img = self._entries.get(path)
            if img is not None:
                self._entries.move_to_end(path)
                self.hits += 1
                return img
            self.misses += 1
        img = imread(path)  # decode outside the lock, so threads overlap
        img.flags.writeable = False
        with self._lock:
            if path not in self._entries:
                self._entries[path] = img
                self._bytes += img.nbytes
                self._evict()
        return img

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


FRAME_CACHE = _FrameCache()


def imread_cached(path: str) -> np.ndarray:
    """`imread` through the process-wide decoded-frame LRU (treat the
    result as read-only). Budget: `FRAME_CACHE.set_budget_mb`."""
    return FRAME_CACHE.get(str(path))


def extract_tile_numpy(img: np.ndarray, x0, y0, x1, y1, factor, tile_side) -> np.ndarray:
    """The numpy version of `extract_tile_native`, byte for byte the same."""
    img = np.ascontiguousarray(img, np.uint8)
    gray = img.ndim == 2
    ch = 1 if gray else img.shape[2]
    tile = np.zeros((tile_side, tile_side, ch), np.uint8)
    roi = img[y0:y1, x0:x1]
    roi = roi.reshape(*roi.shape[:2], ch)  # robust to a clipped/empty slice
    if roi.size:
        if factor > 1:
            oh, ow = roi.shape[0] // factor, roi.shape[1] // factor
            oh, ow = max(oh, 1), max(ow, 1)
            # per-axis block side: a ROI dimension thinner than `factor`
            # still gives one output row/col, averaged over the pixels that
            # exist (the C version does the same)
            by = factor if roi.shape[0] >= factor else roi.shape[0]
            bx = factor if roi.shape[1] >= factor else roi.shape[1]
            r = roi[: oh * by, : ow * bx].reshape(oh, by, ow, bx, ch)
            n = by * bx
            roi = ((r.sum((1, 3), dtype=np.uint32) + n // 2) // n).astype(np.uint8)
        roi = roi[:tile_side, :tile_side]
        tile[: roi.shape[0], : roi.shape[1]] = roi
    return tile[..., 0] if gray else tile


def extract_tile_native(img: np.ndarray, x0, y0, x1, y1, factor, tile_side) -> np.ndarray:
    """ROI slice + integer-area decimation + zero pad -> [T, T, C] uint8.

    `img` may be HxWxC (C up to 4) or HxW (masks: returns [T, T]). In C
    where it builds (without the interpreter lock), else `extract_tile_numpy`.
    """
    lib = native.crop_library()
    if lib is None:
        return extract_tile_numpy(img, x0, y0, x1, y1, factor, tile_side)
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    gray = img.ndim == 2
    ch = 1 if gray else img.shape[2]
    out = np.empty((tile_side, tile_side) if gray else (tile_side, tile_side, ch), np.uint8)
    if lib.metro_extract_tile(img.ctypes.data, h, w, int(x0), int(y0), int(x1), int(y1),
                              int(factor), int(tile_side), ch, out.ctypes.data):
        raise ValueError(f"extract_tile: bad ROI ({x0}, {y0}, {x1}, {y1}) of a {h}x{w}x{ch} "
                         f"image, factor {factor}, tile side {tile_side}")
    return out
