"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources in `metro_pose3d_tpu_torch/csrc/` compile into one shared
library with a plain C interface: pointers, shapes and the CUDA stream go in
as `ctypes` arguments, and each entry point returns `cudaGetLastError()`.
No PyTorch header is included, so nvcc takes seconds, not minutes.

Each source compiles in its own nvcc process, all started together, and
one nvcc call links the objects. The library is built at first use, never
at import time, into
`build/kernels/<hash>/` at the root of the checkout, keyed by a hash of the
sources and the compiler flags, so an edited source rebuilds and an
unchanged one is reused within a checkout.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
# sm_90a: Hopper with its architecture-specific features. No fast math and
# no FMA contraction: the warp rounds every product and sum as the plain
# PyTorch version does, because near the horizon a lens distortion folds
# far-away rays back into the tile, and there the last ulp of a coordinate
# moves the sample by many pixels; the int8 epilogues must equal their
# twins bit for bit, with IEEE division in `quantize`.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")
LIB_NAME = "libmetro_kernels.so"

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # x, y, dtype, vec, B, H, W, C, OH, OW, pad_top, pad_left, fill, stream
    "metro_maxpool3x3s2": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _VP],
    # x, g, dx, dtype, vec, B, H, W, C, OH, OW, pad_top, pad_left, fill, stream
    "metro_maxpool3x3s2_bwd": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _VP],
    # crops, bank, idx, affine, enabled, out, B, N, T, S, stream
    "metro_occluder_paste": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # src, params, src_idx, out, B, N, TH, TW, S, epilogue, out_bf16, unit, scale, offset,
    # stream
    "metro_warp_crop": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _VP],
    # the probes (csrc/probes.cu): x, idx, out, B, H, W, axis, floor_only, stream
    "metro_probe_gather": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    # x, idx, out, B, H, W, reps, stream
    "metro_probe_lane_loop": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # p, s, out, B, R, K, N, reps, split, stream (csrc/rowsel_mma.cu)
    "metro_probe_rowsel": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # x, shift, out, B, H, W, reps, stream
    "metro_probe_roll": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    # x, start, out, B, H, W, R, reps, floor_only, stream
    "metro_probe_dynslice": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # the int8 serving path (csrc/int8_conv.cu, csrc/int8_quant.cu):
    # x, w, out, scale, bias, B, H, W, C, OH, OW, N, KH, KW, stride, dil, pad_top,
    # pad_left, epilogue, out_dtype, relu, variant, bn, bk, stages, tile_w, stream
    "metro_int8_conv": [_VP] * 5 + [_I] * 21 + [_VP],
    # x, scale, bias, out, form, in_dtype, out_dtype, relu, vec, n, C, stream
    "metro_int8_elementwise": [_VP] * 4 + [_I] * 5 + [_LL, _I, _VP],
    # eval batch norm and its activation (csrc/bn_act.cu): x, y, mean, mul, bias, dtype,
    # layout, act (0 none, 1 ReLU, 2 SiLU), vec, n, C, hw, stream
    "metro_bn_act": [_VP] * 5 + [_I] * 4 + [_LL, _I, _LL, _VP],
    # the depthwise conv (csrc/dwconv.cu): x, w, y, dtype, vec, N, H, W, C, OH, OW, k,
    # stride, dilation, pad_top, pad_left, stream
    "metro_dwconv": [_VP] * 3 + [_I] * 13 + [_VP],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (0.0 if cached)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built on this machine")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the hashed build is missing); return the .so path."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [p for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    # build into a temporary directory and name, then rename: a concurrent
    # or interrupted build never leaves a half-written library under the
    # final name
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [work / f"{p.stem}.o" for p in cu]
        jobs = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(p)]
                for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in jobs]
        outputs = [proc.communicate()[0] for proc in procs]  # waits for every one
        tmp = work / LIB_NAME
        for cmd, proc, out in zip(jobs, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
