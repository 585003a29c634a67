"""Build and load the port's CUDA kernels.

The sources under ``vqa_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` on first use — one ``nvcc -c`` per source, all started together,
then one link into a shared library with a plain C interface — and loaded
with ctypes. PyTorch's own extension builder is not used: a source that
includes PyTorch's headers takes minutes to compile, a plain C one seconds.

The library lands in ``vqa_tpu_torch/build/`` under a name keyed by a hash
of the sources and flags, so an edited source is never served a stale
build. It is written to a temporary file and renamed into place, so a
concurrent process never loads a half-written library. A failed build
raises with nvcc's output; nothing falls back to the plain versions.

The compiler is ``$CUDA_HOME/bin/nvcc`` where ``CUDA_HOME`` is set, else
``nvcc`` on ``PATH``, else ``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

from vqa_tpu_torch.utils.profiling import annotate

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("common.cu", "stem.cu", "se.cu", "cross_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (restype is int, a cudaError_t)
    "vqa_stem_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vqa_stem_smem_bytes": [],
    "vqa_stem_bf16_smem_bytes": [],
    # x, w1, w2, out, B, HW, C, R, the plan (cluster, kept rows, split by
    # rows, shared-memory bytes), stream
    "vqa_se_f32": [_P] * 4 + [_I] * 8 + [_P],
    # HW, C, R, the plan, vec, element bytes, out: clusters
    "vqa_se_max_active_clusters": [_I] * 9 + [ctypes.POINTER(_I)],
    # q, k, v, ctx, w, B, H, Lq, Lkv, D, 12 strides (batch, head, row of
    # q, k, v, ctx), 1/scale, stream
    "vqa_cross_attention_f32": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # the bf16 forms: the same arguments, x/w/q/k/v and outputs in bf16 (the
    # stem's scale and bias stay f32)
    # the stem's: + the plan (TMA, shared-memory bytes)
    "vqa_stem_bf16": [_P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "vqa_se_bf16": [_P] * 4 + [_I] * 8 + [_P],
    "vqa_cross_attention_bf16": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    # B, H, Lq, Lkv, D, out[3]: the bf16 form's launch geometry
    "vqa_cross_attention_bf16_geometry": [_I] * 5 + [ctypes.POINTER(_I)],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def nvcc_path() -> str:
    if os.environ.get("CUDA_HOME"):
        return os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libvqa_kernels-{_source_hash()}.so")


def build(verbose: bool = False) -> str:
    """Compile every source in parallel and link the shared library.

    Returns its path. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's
    report (registers, shared memory and spills of each kernel). Recorded
    as the span ``ops.build``."""
    with annotate("ops.build"):
        return _build(verbose)


def _build(verbose: bool) -> str:
    out = library_path()
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix=".objs.") as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC_DIR, name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed, objs = [], []
        for name, obj, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if verbose and log:
                print(f"[nvcc {name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode != 0:
            raise RuntimeError(
                "nvcc link failed:\n" + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vqa_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vqa_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = load_library().vqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


# the element types the kernels take: each kernel has an f32 and a bf16 form
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(t, name: str, dtype=None) -> None:
    """Raise unless ``t`` is f32 or bf16 (``dtype`` where given)."""
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype)[6:]}, got {t.dtype}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def require(t, name: str, shape=None, device=None, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous f32 or bf16 tensor (of ``dtype``
    and ``shape``, on ``device``): what every kernel of this package takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    check_dtype(t, name, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {t.device}: the kernels take CPU or CUDA tensors")


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches``. Kernels launch from several threads (the
    micro-batcher's dispatch thread, HTTP handler threads), and ctypes
    releases the GIL around each launch, so the increment takes a lock."""
    with _count_lock:
        fn.launches += 1


def add_launches(counts) -> None:
    """Add ``n`` to ``fn.launches`` for each (fn, n) in ``counts``: the
    kernels a replayed CUDA graph launches, which no wrapper counts."""
    with _count_lock:
        for fn, n in counts:
            fn.launches += n


def reset_launches(fns) -> None:
    with _count_lock:
        for fn in fns:
            fn.launches = 0
