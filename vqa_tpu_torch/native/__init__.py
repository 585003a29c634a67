"""ctypes binding for the port's C++ host-preprocessing library.

Counterpart of ``vqa_tpu/native/__init__.py:1-203``. The library
(``vqa_preprocess.cc`` beside this file, the port's own copy of the JAX
package's) is a bit-identical reimplementation of PIL's two-pass
fixed-point bilinear resample, batched across a thread pool, plus a fused
uint8 → f32 normalize. It runs on the host: the serving path decodes each
upload with PIL and resizes a whole micro-batch group here
(``data/preprocess.py:resize_batch_to_uint8``).

The library is built on first use with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``vqa_tpu_torch/build/libvqa_preprocess.so``, and rebuilt when the source
is newer than it. The compiler writes a private temporary file that is
renamed into place, so processes that build at once (test workers, a
server and its worker) never load a half-written library.

Where no compiler works, ``available()`` is False and callers take PIL,
which gives the same bytes. The compiler's output is kept:
``build_error()`` returns it, and it is logged once.

The zstd decoder beside it (``zstd.py``, ``zstd_decode.cc``) is built the
same way (``compile_library``) but has no fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "vqa_preprocess.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
LIBRARY = os.path.join(BUILD_DIR, "libvqa_preprocess.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1

_log = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()


def compile_library(source: str, library: str) -> None:
    """Compile ``source`` into a temporary file beside ``library`` and
    rename it over ``library``; raise with the compiler's output on
    failure."""
    build_dir = os.path.dirname(library)
    os.makedirs(build_dir, exist_ok=True)
    prefix = "." + os.path.splitext(os.path.basename(library))[0] + "."
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=prefix, dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def library_is_stale(source: str, library: str) -> bool:
    """True when ``library`` is missing or older than ``source``."""
    return (not os.path.exists(library)
            or os.path.getmtime(source) > os.path.getmtime(library))


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.c_int
    lib.vqa_resize_bilinear_u8.restype = i32
    lib.vqa_resize_bilinear_u8.argtypes = [u8p, i32, i32, u8p, i32, i32, i32]
    lib.vqa_resize_bilinear_u8_batch.restype = i32
    lib.vqa_resize_bilinear_u8_batch.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(i32), ctypes.POINTER(i32), u8p,
        i32, i32, i32, i32, i32]
    lib.vqa_normalize_f32.restype = i32
    lib.vqa_normalize_f32.argtypes = [u8p, f32p, ctypes.c_int64, i32, f32p, f32p]
    lib.vqa_native_abi_version.restype = i32
    lib.vqa_native_abi_version.argtypes = []


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            if library_is_stale(SOURCE, LIBRARY):
                compile_library(SOURCE, LIBRARY)
            lib = ctypes.CDLL(LIBRARY)
            _declare(lib)
            version = lib.vqa_native_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{LIBRARY} has ABI {version}, expected {ABI_VERSION}")
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            _log.warning("native resampler unavailable, PIL resizes instead: %s", _error)
        _tried = True
        return _lib


def available() -> bool:
    """True when the native library is loadable (building it if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's or loader's message),
    or None when it loaded or was not tried yet."""
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def resize_bilinear(src: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H,W,C] u8 → [height,width,C] u8; bit-identical to PIL BILINEAR."""
    lib = _require()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected [H,W,C], got shape {src.shape}")
    sh, sw, ch = src.shape
    dst = np.empty((height, width, ch), np.uint8)
    rc = lib.vqa_resize_bilinear_u8(_u8p(src), sh, sw, _u8p(dst), height, width, ch)
    if rc != 0:
        raise RuntimeError(f"vqa_resize_bilinear_u8 failed: {rc}")
    return dst


def resize_bilinear_batch(srcs: Sequence[np.ndarray], height: int, width: int,
                          num_threads: int = 0) -> np.ndarray:
    """Variable-size [Hi,Wi,C] u8 images → [N,height,width,C] u8, resized in
    parallel on the native thread pool (0 ⇒ hardware concurrency)."""
    lib = _require()
    n = len(srcs)
    if n == 0:
        return np.empty((0, height, width, 3), np.uint8)
    arrs = [np.ascontiguousarray(a, dtype=np.uint8) for a in srcs]
    ch = arrs[0].shape[-1]
    if any(a.ndim != 3 or a.shape[2] != ch for a in arrs):
        raise ValueError("all images must be [H,W,C] with matching C")
    dst = np.empty((n, height, width, ch), np.uint8)
    # arrs holds every source buffer alive for the call
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8p(a) for a in arrs])
    shs = (ctypes.c_int * n)(*[a.shape[0] for a in arrs])
    sws = (ctypes.c_int * n)(*[a.shape[1] for a in arrs])
    rc = lib.vqa_resize_bilinear_u8_batch(ptrs, shs, sws, _u8p(dst), n, height, width,
                                          ch, num_threads)
    if rc != 0:
        raise RuntimeError(f"vqa_resize_bilinear_u8_batch failed: {rc}")
    return dst


def normalize_f32(src: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """u8 [..., C] → f32 (x/255 - mean) / std, fused in C."""
    lib = _require()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    ch = src.shape[-1]
    mean32 = np.ascontiguousarray(mean, np.float32)
    std_inv = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    if mean32.shape != (ch,) or std_inv.shape != (ch,):
        raise ValueError(f"mean and std must have {ch} entries")
    dst = np.empty(src.shape, np.float32)
    rc = lib.vqa_normalize_f32(
        _u8p(src), dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.size // ch, ch,
        mean32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_inv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"vqa_normalize_f32 failed: {rc}")
    return dst
