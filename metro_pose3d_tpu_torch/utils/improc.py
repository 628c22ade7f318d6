"""Host image processing: JPEG and PNG reads, cv2's resize, a decoded-frame
cache, source-tile copy and the reference's small image helpers
(`metro_pose3d_tpu/utils/improc.py`; the port keeps its own copy).

JPEGs are decoded by one backend a process, which `jpeg_backend()` names:
"libjpeg", the port's C decoder against the system libjpeg
(`native/jpegdec.c`), where it builds; otherwise "nvjpeg", nvJPEG on the
GPU (`native/nvjpegdec.cu`, built with nvcc), where it builds and a CUDA
device is present; otherwise a JPEG read raises a RuntimeError that names
both. There is no cv2 or PIL fallback. PNGs are read without cv2: Python's
zlib inflates and `native/pngdec.c` undoes the row filters. It takes 8-bit,
non-interlaced gray, RGB, RGBA and palette files, and gives the pixels
`cv2.imread` gives: gray replicated, a palette looked up (tRNS ignored),
alpha dropped. Other PNGs (16-bit or fewer than 8 bits, gray + alpha,
interlaced) raise, naming the file. Other image formats go through cv2,
imported inside `imread`. `imread_gray` reads an image as `cv2.imread(path,
cv2.IMREAD_GRAYSCALE)` does, for masks: a colour or palette PNG becomes
libpng's luma of its colours. Files that are damaged raise `CorruptImage`,
where cv2.imread gives None; files of a kind the port does not read raise a
plain ValueError. `encode_png` / `imwrite_png` write 8-bit gray, RGB and
RGBA PNGs with zlib alone. `resize` is cv2's INTER_AREA and INTER_LINEAR in C
(`native/resize.c`). The tile copy runs in C (`native/croprep.c`) where the
compiler builds it, in numpy otherwise; both give the same bytes.
Everything returns numpy arrays, RGB where they have colour. This module
imports neither torch nor cv2, so the loader's spawned workers stay light.
"""
from __future__ import annotations

import collections
import concurrent.futures
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


class NoJpegDecoder(RuntimeError):
    """Neither libjpeg nor nvJPEG is available in this process: a JPEG cannot
    be read here. Raised, never swallowed into a fallback."""


_backend = None  # the process's JPEG backend, chosen at the first read
_backend_lock = threading.Lock()


def jpeg_backend() -> str:
    """The process's JPEG decoder: "libjpeg" where `native/jpegdec.c` builds,
    else "nvjpeg" where `native/nvjpegdec.cu` builds and finds a CUDA
    device. Chosen once a process, at the first call; NoJpegDecoder, naming
    both, where neither is available (the choice is then tried again at the
    next call)."""
    global _backend
    with _backend_lock:
        if _backend is None:
            if native.load("jpegdec") is not None:
                _backend = "libjpeg"
            else:
                try:
                    code = native.nvjpeg_library().metro_nvjpeg_init()
                    why = native.nvjpeg_message(code) if code else None
                except RuntimeError as e:
                    why = str(e)
                if why is not None:
                    raise NoJpegDecoder(
                        "reading a JPEG needs libjpeg or nvJPEG, and neither is available. "
                        "libjpeg (jpeglib.h and -ljpeg): the port's decoder native/jpegdec.c "
                        f"did not build:\n{native.build_error('jpegdec')}\nnvJPEG: {why}")
                _backend = "nvjpeg"
        return _backend


def _nvjpeg_check(code: int):
    if code == native.NVJPEG_REFUSED:
        raise CorruptImage("corrupt or unsupported JPEG (nvJPEG refused it)")
    if code:
        raise RuntimeError(native.nvjpeg_message(code))


def _jpeg_dims(data: bytes) -> tuple:
    """(h, w) of JPEG bytes through the process's backend."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if jpeg_backend() == "nvjpeg":
        components = ctypes.c_int()
        _nvjpeg_check(native.nvjpeg_library().metro_nvjpeg_dims(
            data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(components)))
    elif native.jpeg_library().metro_jpeg_dims(data, len(data), ctypes.byref(h),
                                               ctypes.byref(w)):
        raise CorruptImage("corrupt or unsupported JPEG")
    return h.value, w.value


def decode_jpeg_bytes(data: bytes, gray: bool = False) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [H, W, 3], or with `gray` the luma [H, W] as
    libjpeg gives it (cv2's IMREAD_GRAYSCALE), through the process's backend
    (`jpeg_backend`); CorruptImage if the backend refuses them."""
    data = bytes(data)
    h, w = _jpeg_dims(data)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if jpeg_backend() == "nvjpeg":
        _nvjpeg_check(native.nvjpeg_library().metro_nvjpeg_decode(
            data, len(data), out.ctypes.data, h, w, int(gray)))
        return out
    lib = native.jpeg_library()
    decode = lib.metro_decode_jpeg_gray if gray else lib.metro_decode_jpeg
    if decode(data, len(data), out.ctypes.data, h, w):
        raise CorruptImage("corrupt or unsupported JPEG")
    return out


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel (0 gray, 2 RGB, 3 palette index, 6 RGBA);
# 4 (gray + alpha) is not read
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_PNG_PALETTE = 3
# libpng's rgb_to_gray weights for cv2's (0.299, 0.587), at 15 bits
_LUMA15 = np.array([9797, 19234, 3737], np.uint32)
# chunks after which libpng's rgb_to_gray works through gamma tables
_PNG_GAMMA_CHUNKS = (b"sRGB", b"iCCP")
_PNG_UNIT_GAMMA = struct.pack(">I", 100000)


def decode_png_bytes(data: bytes, gray: bool = False, name: str = "PNG") -> np.ndarray:
    """PNG bytes -> RGB uint8 [H, W, 3] (gray replicated, a palette looked
    up, alpha and tRNS dropped, as cv2.imread's IMREAD_COLOR), or with
    `gray` uint8 [H, W] as IMREAD_GRAYSCALE gives it (a colour PNG's luma,
    or a palette PNG's luma of each index's colour, as libpng computes it;
    indices past the palette read as black, as libpng gives them).
    Errors name `name`: CorruptImage for a damaged file (truncated, a bad
    CRC, length or row filter, corrupt data, a palette PNG without a valid
    PLTE); ValueError for one it does not read (not a PNG, a bit depth other
    than 8, gray + alpha, interlacing, or colour with `gray` under a gamma
    chunk)."""
    data = bytes(data)
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    header, idat, pos, gamma, palette = None, [], 8, False, None
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
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise CorruptImage(f"{name}: PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or compression or filtering or interlace:
        what = ("a bit depth of %d" % depth if depth != 8
                else "Adam7 interlacing" if interlace
                else f"colour type {color}, compression {compression}, filter {filtering}")
        raise ValueError(f"{name}: PNG with {what}; the port reads 8-bit, non-interlaced "
                         "gray, RGB, RGBA and palette PNGs")
    ch = _PNG_CHANNELS[color]
    if color == _PNG_PALETTE:
        if palette is None or not palette or len(palette) % 3 or len(palette) > 3 * 256:
            raise CorruptImage(f"{name}: a palette PNG without a valid PLTE chunk "
                               f"({None if palette is None else len(palette)} bytes)")
        colours = np.zeros((256, 3), np.uint8)
        colours[:len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    if gray and (ch > 1 or color == _PNG_PALETTE) and gamma:
        raise ValueError(f"{name}: a colour or palette PNG with a gamma chunk read as gray; "
                         "the port reads them as gray only without gAMA, sRGB or iCCP")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"{name}: corrupt PNG data ({e})") from None
    if len(raw) != h * (1 + w * ch):
        raise CorruptImage(f"{name}: {len(raw)} bytes of PNG data for {h}x{w}x{ch}")
    out = np.empty((h, w, ch), np.uint8)
    if native.png_library().metro_png_unfilter(raw, len(raw), h, w, ch, out.ctypes.data):
        raise CorruptImage(f"{name}: a PNG row filter above 4")
    if color == _PNG_PALETTE:
        if gray:
            return ((colours @ _LUMA15) >> 15).astype(np.uint8)[out.reshape(h, w)]
        return colours[out.reshape(h, w)]
    if ch == 1:
        return out.reshape(h, w) if gray else np.repeat(out, 3, axis=-1)
    if gray:
        return ((out[..., :3] @ _LUMA15) >> 15).astype(np.uint8)
    return out if ch == 3 else np.ascontiguousarray(out[..., :3])


def decode_jpeg_batch(items, threads: int = 4) -> list:
    """list[bytes] -> list[RGB uint8 array], decoded on `threads` threads (in
    C with libjpeg; with nvJPEG, a Python thread a decode, each with its own
    nvJPEG state and stream); ValueError naming the first item the backend
    refuses."""
    items = [bytes(d) for d in items]
    if not items:
        return []
    if jpeg_backend() == "nvjpeg":
        def one(i):
            try:
                return decode_jpeg_bytes(items[i])
            except CorruptImage as e:
                raise ValueError(f"item {i}: {e}") from None

        with concurrent.futures.ThreadPoolExecutor(max(1, int(threads))) as pool:
            return list(pool.map(one, range(len(items))))
    lib = native.jpeg_library()
    n = len(items)
    dims = []
    for i, d in enumerate(items):
        try:
            dims.append(_jpeg_dims(d))
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
    """Image file -> RGB uint8; JPEG through `decode_jpeg_bytes`, PNG through
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
    `decode_jpeg_bytes`, a PNG through `decode_png_bytes`; ValueError for
    other formats."""
    lower = str(path).lower()
    if lower.endswith((".jpg", ".jpeg")):
        return decode_jpeg_bytes(_read_bytes(path), gray=True)
    if lower.endswith(".png"):
        return decode_png_bytes(_read_bytes(path), gray=True, name=str(path))
    raise ValueError(f"{path}: the port reads masks from JPEG and PNG files only")


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> the bytes
    of an 8-bit, non-interlaced PNG: every row unfiltered (filter type 0),
    the rows deflated by zlib. `decode_png_bytes` reads it back."""
    img = np.ascontiguousarray(img)
    ch = 1 if img.ndim == 2 else img.shape[-1]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or ch not in (1, 3, 4):
        raise ValueError(f"encode_png takes uint8 [H, W], [H, W, 3] or [H, W, 4], "
                         f"got {img.dtype} {list(img.shape)}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + w * ch), np.uint8)  # each row: filter byte 0, then its pixels
    raw[:, 1:] = img.reshape(h, w * ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def imwrite_png(path: str, img: np.ndarray) -> str:
    """Write `img` (see `encode_png`) to `path` as a PNG -> path."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


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


_INTERPOLATIONS = {"area": 0, "linear": 1}  # cv2.INTER_AREA, cv2.INTER_LINEAR


def resize(img: np.ndarray, size, interpolation: str) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_AREA or
    cv2.INTER_LINEAR)` without cv2, in C (`native/resize.c`, which follows
    cv2 5.0's branches: uint8 results are cv2's, float32 area results too,
    float32 linear ones within a float32 ulp). `size` is (width, height) as
    cv2 takes it; `interpolation` "area" or "linear"; `img` uint8 or
    float32, [H, W] or [H, W, C] with C 1, 3 or 4. The result keeps the
    input's layout (cv2 drops a channel axis of 1). ValueError for other
    inputs."""
    if interpolation not in _INTERPOLATIONS:
        raise ValueError(f"resize: interpolation {interpolation!r}, not one of "
                         f"{sorted(_INTERPOLATIONS)}")
    w, h = (int(v) for v in size)
    img = np.ascontiguousarray(img)
    if (img.dtype not in (np.uint8, np.float32) or img.ndim not in (2, 3)
            or (img.ndim == 3 and img.shape[2] not in (1, 3, 4))
            or min(img.shape[:2]) < 1 or w < 1 or h < 1):
        raise ValueError(f"resize: a {img.dtype} image of shape {img.shape} to {(w, h)}; the "
                         "port resizes uint8 and float32 images of 1, 3 or 4 channels to "
                         "a size of at least 1x1")
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty((h, w) + img.shape[2:], img.dtype)
    code = native.resize_library().metro_resize(
        img.ctypes.data, img.shape[0], img.shape[1], cn, int(img.dtype == np.float32),
        out.ctypes.data, h, w, _INTERPOLATIONS[interpolation])
    if code:
        raise MemoryError(f"resize of a {img.shape} image to {(w, h)}: code {code}")
    return out


def resize_by_factor(img: np.ndarray, factor: float) -> np.ndarray:
    """Anti-aliased resize by a scale factor (area for shrink, linear for
    grow), the reference's `improc.resize_by_factor`."""
    new_size = (
        max(1, int(round(img.shape[1] * factor))),
        max(1, int(round(img.shape[0] * factor))),
    )
    return resize(img, new_size, "area" if factor < 1.0 else "linear")


def white_balance(img: np.ndarray, strength: float = 1.0) -> np.ndarray:
    """Gray-world white balance (the reference's host-side colour-adjust
    primitive). `strength` in [0, 1] interpolates toward full correction."""
    img_f = img.astype(np.float32)
    means = img_f.reshape(-1, img_f.shape[-1]).mean(0)
    gray = means.mean()
    gains = gray / np.maximum(means, 1e-6)
    gains = 1.0 + (gains - 1.0) * strength
    return np.clip(img_f * gains, 0, 255).astype(np.uint8)


def paste_over(im_src: np.ndarray, im_dst: np.ndarray, center_xy) -> np.ndarray:
    """Alpha-composite RGBA `im_src` over RGB `im_dst` centred at
    `center_xy` (the reference's occluder-pasting primitive for host-side
    tooling; the training path pastes on the device, `ops/occlusion.py`)."""
    h_s, w_s = im_src.shape[:2]
    h_d, w_d = im_dst.shape[:2]
    cx, cy = center_xy
    x0 = int(round(cx - w_s / 2))
    y0 = int(round(cy - h_s / 2))
    x1, y1 = x0 + w_s, y0 + h_s
    dx0, dy0 = max(x0, 0), max(y0, 0)
    dx1, dy1 = min(x1, w_d), min(y1, h_d)
    if dx0 >= dx1 or dy0 >= dy1:
        return im_dst
    sx0, sy0 = dx0 - x0, dy0 - y0
    sx1, sy1 = sx0 + (dx1 - dx0), sy0 + (dy1 - dy0)
    src = im_src[sy0:sy1, sx0:sx1]
    out = im_dst.copy()
    region = out[dy0:dy1, dx0:dx1].astype(np.float32)
    alpha = src[..., 3:4].astype(np.float32) / 255.0
    rgb = src[..., :3].astype(np.float32)
    out[dy0:dy1, dx0:dx1] = (alpha * rgb + (1 - alpha) * region).astype(np.uint8)
    return out
