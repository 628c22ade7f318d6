"""Build the port's host runtime with the machine's C compiler (and, for
nvJPEG, nvcc) and load it with ctypes.

Five libraries, each with a plain C interface (no Python.h):

  croprep   `croprep.c`: the crop-parameter engine and the source-tile copy.
            Needs only libm. The loader's native engine.
  jpegdec   `jpegdec.c`: JPEG decoding against the system libjpeg, built
            only when a JPEG is read, so that crop prep never needs libjpeg.
  pngdec    `pngdec.c`: PNG row unfiltering (libc only), built when a PNG
            is read; Python's zlib inflates.
  resize    `resize.c`: cv2's INTER_AREA and INTER_LINEAR resize (libm
            only), built when an image is resized.
  nvjpegdec `nvjpegdec.cu`: JPEG decoding on the GPU through nvJPEG, for a
            machine without libjpeg; built with nvcc against the CUDA
            toolkit's `nvjpeg.h` and `libnvjpeg.so` (`nvjpeg_paths`), with
            an rpath to the latter, only when `utils/improc.py` finds no
            libjpeg.

Each is built at first use, never at import time, into
`build/native/<hash>/` at the root of the checkout, keyed by a hash of its
source, the compiler and the flags. The build writes into a temporary
directory and renames the library into place, so concurrent builds (test
workers, loader processes) never load a half-written file. A failed build is
remembered for the process: `crop_library()` then returns None (the `auto`
engine falls back to numpy) and `build_error("croprep")` says why;
`jpeg_library()` raises, naming libjpeg, and `nvjpeg_library()` names what
nvJPEG's build lacked.

Flags: -O3 without -march=native, since a checkout may be copied to another
host with the build directory, and -ffp-contract=off, so that no product and
sum fuse into an FMA the numpy code does not make (the engines then agree to
~1e-12 relative in float64).
"""
from __future__ import annotations

import ctypes
import glob
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
        "pngdec": ("pngdec.c", ()), "resize": ("resize.c", ("-lm",))}
NVJPEG_SRC = "nvjpegdec.cu"
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

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
    "resize": {
        # src, sh, sw, cn, is_f32, dst, dh, dw, interp
        "metro_resize": [_P, _I, _I, _I, _I, _P, _I, _I, _I],
    },
    "nvjpegdec": {
        "metro_nvjpeg_init": [],
        # &major, &minor, &patch
        "metro_nvjpeg_version": [_P, _P, _P],
        # data, len, &h, &w, &components
        "metro_nvjpeg_dims": [ctypes.c_char_p, _SZ, _P, _P, _P],
        # data, len, out, h, w, gray
        "metro_nvjpeg_decode": [ctypes.c_char_p, _SZ, _P, _I, _I, _I],
    },
}
# metro_nvjpeg_* codes other than 0 (`nvjpeg_message`)
NVJPEG_REFUSED, NVJPEG_NO_DEVICE, NVJPEG_FAULT, NVJPEG_CUDA_FAULT = 1, 2, 100, 1000

_lock = threading.Lock()
_loaded: dict = {}  # name -> CDLL, or the build's error message
build_seconds: dict = {}  # name -> wall seconds of the build in this process (0.0 if reused)


def _compiler() -> str:
    return os.environ.get("CC") or "cc"


def nvjpeg_paths() -> tuple:
    """(nvcc, the directory of `nvjpeg.h`, the directory of `libnvjpeg.so*`)
    of the CUDA toolkit: searched under CUDA_HOME, CUDA_PATH and nvcc's
    prefix, in `include/` and `targets/*/include`, and `lib64/`, `lib/`
    and `targets/*/lib`. RuntimeError naming the roots searched where nvcc,
    the header or the library is missing."""
    from metro_pose3d_tpu_torch.kernels.build import _nvcc

    nvcc = _nvcc()  # RuntimeError where there is none
    roots = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))]
    roots = sorted({r for r in roots if r and os.path.isdir(r)})
    headers, libs = [], []
    for r in roots:
        for sub in ("include", os.path.join("targets", "*", "include")):
            headers += glob.glob(os.path.join(r, sub, "nvjpeg.h"))
        for sub in ("lib64", "lib", os.path.join("targets", "*", "lib")):
            libs += glob.glob(os.path.join(r, sub, "libnvjpeg.so*"))
    if not headers or not libs:
        raise RuntimeError(f"nvJPEG not found under {roots}: nvjpeg.h {sorted(headers) or 'none'},"
                           f" libnvjpeg.so* {sorted(libs) or 'none'}")
    return nvcc, os.path.dirname(sorted(headers)[0]), os.path.dirname(sorted(libs)[0])


def _command(name: str, out: Path) -> list:
    """The compiler command that builds library `name` into `out`."""
    if name == "nvjpegdec":
        nvcc, include, lib = nvjpeg_paths()
        return [nvcc, *NVCC_FLAGS, "-I", include, str(NATIVE / NVJPEG_SRC), "-L", lib,
                "-lnvjpeg", "-Xlinker", f"-rpath,{lib}", "-Xlinker", "--disable-new-dtags",
                "-o", str(out)]
    src, link = LIBS[name]
    return [_compiler(), *CFLAGS, str(NATIVE / src), *link, "-o", str(out)]


def _lib_path(name: str) -> Path:
    """build/native/<hash of the command and the source>/libmetro_<name>.so"""
    src = NVJPEG_SRC if name == "nvjpegdec" else LIBS[name][0]
    h = hashlib.sha256(" ".join(_command(name, Path(f"libmetro_{name}.so"))).encode())
    h.update((NATIVE / src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"libmetro_{name}.so"


def build(name: str) -> Path:
    """Compile library `name` (if its hashed build is missing) -> its path.
    Raises RuntimeError with the compiler's output when the build fails, or
    naming what nvJPEG's build lacks."""
    lib_path = _lib_path(name)
    if lib_path.exists():
        build_seconds[name] = 0.0
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=lib_path.parent))
    try:
        tmp = work / lib_path.name
        cmd = _command(name, tmp)
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


def resize_library():
    """cv2's area and linear resize; raises RuntimeError where the C
    compiler cannot build it."""
    lib = load("resize")
    if lib is None:
        raise RuntimeError("resizing needs the port's resize (native/resize.c), which did not "
                           f"build on this machine:\n{build_error('resize')}")
    return lib


def nvjpeg_library():
    """The nvJPEG decoder, built with nvcc at first use; raises RuntimeError,
    saying what was missing, where it cannot be built or loaded here (no
    nvcc, no nvJPEG in the toolkit, a failed build). Whether a card is
    present is the caller's question (`metro_nvjpeg_init`)."""
    lib = load("nvjpegdec")
    if lib is None:
        raise RuntimeError(f"the nvJPEG decoder (native/{NVJPEG_SRC}) did not build or load on "
                           f"this machine:\n{build_error('nvjpegdec')}")
    return lib


def nvjpeg_message(code: int) -> str:
    """What a metro_nvjpeg_* code other than 0 means."""
    if code == NVJPEG_REFUSED:
        return "nvJPEG refused the data (corrupt or unsupported JPEG)"
    if code == NVJPEG_NO_DEVICE:
        return "nvJPEG found no CUDA device"
    if code >= NVJPEG_CUDA_FAULT:
        return f"nvJPEG decode: CUDA error {code - NVJPEG_CUDA_FAULT}"
    if code >= NVJPEG_FAULT:
        return f"nvJPEG decode: nvjpegStatus_t {code - NVJPEG_FAULT}"
    return f"nvJPEG decode: unknown code {code}"
