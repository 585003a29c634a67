"""ctypes binding for the port's zstd decoder (``zstd_decode.cc``).

An Orbax checkpoint keeps its B-tree nodes and its zarr chunks as zstd
frames; this decoder reads them where no zstd library is installed. The
library is built on first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``vqa_tpu_torch/build/libzstd_decode.so`` (a private
temporary file renamed into place, rebuilt when the source is newer), as
the resampler beside it is. There is no fallback: a failed build raises
with the compiler's output.

Every call states the decoded size it expects, and input that decodes to
another size raises ``ZstdError``, as does any malformed frame. A frame
that sets its checksum flag is checked against its XXH64; one that does
not cannot show every flipped byte.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from vqa_tpu_torch import native

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd_decode.cc")
LIBRARY = os.path.join(native.BUILD_DIR, "libzstd_decode.so")
ABI_VERSION = 2
ALIGN = 64  # each output of decompress_many starts at a multiple of this
_ERR_LEN = 512

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class ZstdError(ValueError):
    """A frame that is malformed or decodes to another size than expected."""


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.c_void_p
    size = ctypes.c_size_t
    lib.zstd_decode.restype = ctypes.c_int64
    lib.zstd_decode.argtypes = [u8p, size, u8p, size, ctypes.c_int, ctypes.c_char_p, size]
    lib.zstd_decode_many.restype = ctypes.c_int
    lib.zstd_decode_many.argtypes = [
        ctypes.c_int, u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int, u8p, ctypes.c_char_p, size]
    lib.zstd_content_size.restype = ctypes.c_int64
    lib.zstd_content_size.argtypes = [u8p, size, ctypes.c_char_p, size]
    lib.zstd_abi_version.restype = ctypes.c_int
    lib.zstd_abi_version.argtypes = []


def load() -> ctypes.CDLL:
    """The decoder library, built first if it is missing or stale. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if native.library_is_stale(SOURCE, LIBRARY):
                native.compile_library(SOURCE, LIBRARY)
            lib = ctypes.CDLL(LIBRARY)
            _declare(lib)
            version = lib.zstd_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{LIBRARY} has ABI {version}, expected {ABI_VERSION}")
            _lib = lib
    return _lib


def _view(buf) -> np.ndarray:
    """A uint8 view of a bytes-like object (bytes, bytearray, memoryview,
    mmap), without a copy; it keeps the object alive."""
    return np.frombuffer(buf, np.uint8)


def content_size(frames) -> Optional[int]:
    """The summed content size that ``frames`` state in their headers, or
    None where a frame does not state it."""
    lib = load()
    data = _view(frames)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.zstd_content_size(data.ctypes.data, data.size, err, _ERR_LEN)
    if n == -2:
        raise ZstdError(err.value.decode())
    return None if n == -1 else int(n)


def decompress(frames, size: int) -> np.ndarray:
    """Decode ``frames`` (one or more frames in a row, skippable frames
    allowed) into a new uint8 array of exactly ``size`` bytes."""
    lib = load()
    data = _view(frames)
    if size < 0:
        raise ValueError(f"expected size must be >= 0, got {size}")
    out = np.empty(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.zstd_decode(data.ctypes.data, data.size, out.ctypes.data, size, 1, err, _ERR_LEN)
    if n < 0:
        raise ZstdError(err.value.decode())
    return out


def decompress_bounded(frames, limit: int) -> np.ndarray:
    """Decode ``frames`` whose size is not stated, into at most ``limit``
    bytes; returns a copy of what they decode to."""
    lib = load()
    data = _view(frames)
    out = np.empty(limit, np.uint8)  # pages past the decoded size are never touched
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.zstd_decode(data.ctypes.data, data.size, out.ctypes.data, limit, 0, err, _ERR_LEN)
    if n < 0:
        raise ZstdError(err.value.decode())
    return out[:n].copy()


def decompress_many(frames_list: Sequence, sizes: Sequence[int],
                    num_threads: int = 0) -> List[np.ndarray]:
    """Decode each of ``frames_list`` (bytes-like) to exactly its
    ``sizes[i]`` bytes, all in one call across the library's thread pool
    (0: one thread per core). Returns uint8 arrays that are views of one
    buffer, each starting ``ALIGN``-aligned. Raises ``ZstdError`` naming
    the first input that failed."""
    n = len(frames_list)
    if n != len(sizes):
        raise ValueError(f"{n} inputs for {len(sizes)} sizes")
    if n == 0:
        return []
    lib = load()
    src = np.frombuffer(b"".join(frames_list), np.uint8)
    if min(sizes) < 0:
        raise ValueError("sizes must be >= 0")
    src_sizes = np.fromiter((len(f) for f in frames_list), np.uint64, n)
    dst_sizes = np.asarray(sizes, np.uint64)
    padded = (dst_sizes + np.uint64(ALIGN - 1)) // np.uint64(ALIGN) * np.uint64(ALIGN)
    src_offsets, dst_offsets = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    np.cumsum(src_sizes[:-1], out=src_offsets[1:])
    np.cumsum(padded[:-1], out=dst_offsets[1:])
    # over-allocate by ALIGN to start the first output on an aligned address
    raw = np.empty(int(padded.sum()) + ALIGN, np.uint8)
    dst = raw[-raw.ctypes.data % ALIGN:][:int(padded.sum())]
    status = np.zeros(n, np.intc)
    err = ctypes.create_string_buffer(_ERR_LEN)
    failures = lib.zstd_decode_many(
        n, src.ctypes.data if src.size else 0, src_offsets.ctypes.data, src_sizes.ctypes.data,
        dst.ctypes.data if dst.size else 0, dst_offsets.ctypes.data, dst_sizes.ctypes.data,
        num_threads, status.ctypes.data, err, _ERR_LEN)
    if failures:
        first = int(np.flatnonzero(status)[0])
        raise ZstdError(f"input {first} of {n} ({failures} failed): {err.value.decode()}")
    return [dst[int(o):int(o) + int(k)] for o, k in zip(dst_offsets, dst_sizes)]
