"""Build the port's host runtime with the machine's C compiler and load it
with ctypes.

Three libraries, each with a plain C interface (no Python.h):

  croprep   `croprep.c`: the crop-parameter engine and the source-tile copy.
            Needs only libm. The loader's native engine.
  jpegdec   `jpegdec.c`: JPEG decoding against the system libjpeg, built
            only when a JPEG is read, so that crop prep never needs libjpeg.
  pngdec    `pngdec.c`: PNG row unfiltering (libc only), built when a PNG
            is read; Python's zlib inflates.

Each is built at first use, never at import time, into
`build/native/<hash>/` at the root of the checkout, keyed by a hash of its
source, the compiler and the flags. The build writes into a temporary
directory and renames the library into place, so concurrent builds (test
workers, loader processes) never load a half-written file. A failed build is
remembered for the process: `crop_library()` then returns None (the `auto`
engine falls back to numpy) and `build_error("croprep")` says why;
`jpeg_library()` raises, naming libjpeg.

Flags: -O3 without -march=native, since a checkout may be copied to another
host with the build directory, and -ffp-contract=off, so that no product and
sum fuse into an FMA the numpy code does not make (the engines then agree to
~1e-12 relative in float64).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

NATIVE = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")
# name: (source, link flags)
LIBS = {"croprep": ("croprep.c", ("-lm",)), "jpegdec": ("jpegdec.c", ("-ljpeg",)),
        "pngdec": ("pngdec.c", ())}

_P, _I, _D, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_size_t
SIGNATURES = {
    "croprep": {
        # cam, bbox, proc, tile, img_w, img_h, expansion, shift_x, shift_y, scale, rot,
        # flip, mode, J, coords, valid, mirror, out, roi
        "metro_crop_params": [_P, _P, _I, _I, _I, _I, _D, _D, _D, _D, _D, _I, _I, _I,
                              _P, _P, _P, _P, _P],
        # img, h, w, x0, y0, x1, y1, factor, tile_side, ch, out
        "metro_extract_tile": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "jpegdec": {
        # data, len, &h, &w
        "metro_jpeg_dims": [ctypes.c_char_p, _SZ, _P, _P],
        # data, len, out, h, w
        "metro_decode_jpeg": [ctypes.c_char_p, _SZ, _P, _I, _I],
        "metro_decode_jpeg_gray": [ctypes.c_char_p, _SZ, _P, _I, _I],
        # datas, lens, outs, hs, ws, n, threads, status
        "metro_decode_jpeg_batch": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "pngdec": {
        # raw, raw_len, h, w, bpp, out
        "metro_png_unfilter": [ctypes.c_char_p, _SZ, _I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_loaded: dict = {}  # name -> CDLL, or the build's error message
build_seconds: dict = {}  # name -> wall seconds of the build in this process (0.0 if reused)


def _compiler() -> str:
    return os.environ.get("CC") or "cc"


def _lib_path(name: str) -> Path:
    src, link = LIBS[name]
    h = hashlib.sha256(" ".join((_compiler(), *CFLAGS, *link)).encode())
    h.update((NATIVE / src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"libmetro_{name}.so"


def build(name: str) -> Path:
    """Compile library `name` (if its hashed build is missing) -> its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    src, link = LIBS[name]
    lib_path = _lib_path(name)
    if lib_path.exists():
        build_seconds[name] = 0.0
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=lib_path.parent))
    try:
        tmp = work / lib_path.name
        cmd = [_compiler(), *CFLAGS, str(NATIVE / src), *link, "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds[name] = time.perf_counter() - t0
    return lib_path


def load(name: str):
    """Library `name` as a ctypes CDLL, built on first call; None when it
    cannot be built or loaded here (`build_error(name)` says why)."""
    with _lock:
        if name not in _loaded:
            try:
                lib = ctypes.CDLL(str(build(name)))
            except (RuntimeError, OSError) as e:
                _loaded[name] = str(e)
            else:
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _loaded[name] = lib
        got = _loaded[name]
        return None if isinstance(got, str) else got


def build_error(name: str):
    """Why library `name` did not load in this process, or None."""
    got = _loaded.get(name)
    return got if isinstance(got, str) else None


def crop_library():
    """The crop engine and tile copy, or None where the compiler fails."""
    return load("croprep")


def jpeg_library():
    """The JPEG decoder; raises RuntimeError, naming libjpeg, where it
    cannot be built (no libjpeg headers or library on this machine)."""
    lib = load("jpegdec")
    if lib is None:
        raise RuntimeError(
            "reading a JPEG needs libjpeg (jpeglib.h and -ljpeg), and the port's JPEG "
            f"decoder (native/jpegdec.c) did not build on this machine:\n{build_error('jpegdec')}")
    return lib


def png_library():
    """The PNG row unfilter; raises RuntimeError where the C compiler
    cannot build it."""
    lib = load("pngdec")
    if lib is None:
        raise RuntimeError("reading a PNG needs the port's PNG unfilter (native/pngdec.c), "
                           f"which did not build on this machine:\n{build_error('pngdec')}")
    return lib
