"""ctypes bridge to the native C++ image ops (csrc/image_ops.cpp).

Counterpart of textboost_tpu/data/native.py.  The library is built with
g++ at first use into `textboost_torch/csrc/build/`, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
reused.  The loader's threads build it once, under a lock; processes that
share the checkout may race for the first build: each compiles to a
temporary name in the build dir and renames it into place, which is
atomic, so a reader never sees a half-written library.

A missing compiler or a failed build raises with the compiler's message;
there is no quiet fallback.  The PIL path of `exec_adjust_scale`
(`data/augment.py::exec_adjust_scale_pil`) is the plain version that the
tests hold the native op against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "image_ops.cpp"
BUILD_DIR = SRC.parent / "build"
# -ffp-contract=off: FMA contraction perturbs the double arithmetic that
# affine_scale_bicubic_u8 must keep bit-exact with PIL's (truncation
# boundaries flip on ~1% of pixels).
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"image_ops-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native image ops cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.normalize_u8_to_f32.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ]
            lib.affine_scale_bicubic_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ]
            _LIB = lib
        return _LIB


def affine_scale_bicubic(arr: np.ndarray, pad_w: int, pad_h: int,
                         out_w: int, out_h: int, a0: float, a2: float,
                         a4: float, a5: float) -> np.ndarray:
    """Axis-aligned bicubic affine resample over an edge-padded extent,
    bit-exact with PIL Image.transform(AFFINE, BICUBIC) on np.pad(edge).
    The pad is virtual (index clamping)."""
    lib = get_lib()
    assert arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3
    src = np.ascontiguousarray(arr)
    dst = np.empty((out_h, out_w, 3), np.uint8)
    lib.affine_scale_bicubic_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(src.shape[0]), ctypes.c_int32(src.shape[1]),
        ctypes.c_int32(pad_w), ctypes.c_int32(pad_h),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(out_h), ctypes.c_int32(out_w),
        ctypes.c_double(a0), ctypes.c_double(a2),
        ctypes.c_double(a4), ctypes.c_double(a5),
    )
    return dst


def normalize_u8(arr: np.ndarray, mean: float = 0.5, std: float = 0.5,
                 threads: int = 4) -> np.ndarray:
    """uint8 array -> float32 (x/255 - mean)/std."""
    assert arr.dtype == np.uint8
    lib = get_lib()
    src = np.ascontiguousarray(arr)
    dst = np.empty(src.shape, np.float32)
    lib.normalize_u8_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(src.size), ctypes.c_float(mean), ctypes.c_float(1.0 / std),
        ctypes.c_int(threads),
    )
    return dst
