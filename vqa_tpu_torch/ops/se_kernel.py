"""Squeeze-and-Excitation: pool → FC → ReLU → FC → sigmoid → rescale.

Counterpart of ``vqa_tpu/ops/se_kernel.py``. ``fused_se`` launches the
hand-written CUDA kernel of ``csrc/se.cu`` on a CUDA tensor — one
thread-block cluster per image, which holds the image in shared memory
where it fits, so x is read from device memory once — and computes
``plain_se`` on a CPU tensor. x is NHWC as in the JAX package; the weights
are the ``nn.Linear`` layouts ``SEAttention`` stores ([out, in]), the
transposes of the flax kernels ``fused_se`` of the JAX package takes.

``se_plan`` computes the launch plan (cluster size, split by rows or by
channels, rows kept in shared memory, shared-memory bytes) in plain
Python; the launcher refuses a plan that does not match its own layout.

bf16 x (with bf16 weights) launches the bf16 form's own kernel
(``fused_se_bf16``, ``csrc/se.cu:se_bf16``): pooling, both FCs and the
scales in f32, the output rounded once to bf16, as the Pallas kernel
computes a bf16 block. Its plan (``esize=2``) counts 2-byte elements, so a
block keeps twice the rows in the same shared memory (and 16 bytes more
for the mbarrier of its exchange).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from vqa_tpu_torch.ops._build import check, count_launch, load_library, require, stream_of

ESIZE = {torch.float32: 4, torch.bfloat16: 2}  # bytes per element of each form

THREADS = 256       # threads per block, as csrc/se.cu
MAX_SMEM = 232_448  # dynamic shared memory one block may use (227 KB)
MAX_WEIGHT_SMEM = 48 * 1024  # a block's weights are staged when they fit
NUM_SMS = 132       # H100 SXM
SM_SHARED = 233_472  # shared memory of one SM (228 KB); each block also reserves 1 KB
# share of the card's block slots that clusters of 8 to 16 fill, measured on
# the H100 with cudaOccupancyMaxActiveClusters (30 of 33 clusters of 8 at
# two blocks per SM, 45 of 49.5 at three): the GPCs do not divide evenly
CLUSTER_FILL = 0.9


def _round16(v: int) -> int:
    return (v + 15) & ~15


def slice_width(c: int, cluster: int, esize: int = 4) -> int:
    """Channels each block of a cluster split by channels owns:
    ceil(C/cluster), rounded up to a multiple of 16/esize (a 16-byte
    vector: 4 f32 or 8 bf16) where C is one."""
    cs = -(-c // cluster)
    per16 = 16 // esize
    return -(-cs // per16) * per16 if c % per16 == 0 else cs


def _smem_bytes(c: int, r: int, cluster: int, keep_rows: int, rows: bool,
                esize: int = 4) -> int:
    """Bytes of csrc/se.cu's shared-memory layout for a block owning w
    channels (all C split by rows, a slice split by channels) of
    esize-byte elements: the bf16 form's exchange mbarrier (16 bytes); what
    every rank pushes (f32 [cluster, C] sums or [cluster, R] shares); f32
    pooled means and scales [w]; the f32 hidden units [R]; the block's
    weights [R, w] twice where they fit MAX_WEIGHT_SMEM; the f32 pooling
    scratch; the kept rows [keep, w]. Each part is rounded up to 16 bytes
    but the last."""
    w = c if rows else slice_width(c, cluster, esize)
    weights = 2 * _round16(esize * r * w) if 2 * esize * r * w <= MAX_WEIGHT_SMEM else 0
    bar = 16 if esize == 2 else 0  # the bf16 form's exchange mbarrier
    return (bar + _round16(4 * cluster * (c if rows else r)) + 2 * _round16(4 * w)
            + _round16(4 * r) + weights + _round16(4 * max(w, 16 // esize * THREADS))
            + keep_rows * w * esize)


@dataclass(frozen=True)
class SEPlan:
    cluster: int     # blocks per image: one thread-block cluster
    rows: bool       # split by rows (each block all channels), else by channels
    keep_rows: int   # rows a block holds in shared memory; the rest stream
    smem_bytes: int  # dynamic shared memory per block

    def block_rows(self, hw: int) -> int:
        """The most rows one block owns."""
        return -(-hw // self.cluster) if self.rows else hw

    def resident(self, hw: int) -> bool:
        """Every row is read from device memory once."""
        return self.keep_rows == self.block_rows(hw)

    def tiles(self, hw: int, c: int, esize: int = 4):
        """The [r0, r1) x [c0, c1) each block owns, as the kernel splits."""
        n = self.cluster
        if self.rows:
            return [(q * hw // n, (q + 1) * hw // n, 0, c) for q in range(n)]
        cs = slice_width(c, n, esize)
        return [(0, hw, min(c, q * cs), min(c, (q + 1) * cs)) for q in range(n)]


@functools.lru_cache(maxsize=256)
def se_plan(b: int, hw: int, c: int, r: int, esize: int = 4) -> SEPlan:
    """The launch plan of one ``fused_se`` call on x [b, hw, c] with r
    hidden units and esize-byte elements (4: f32, 2: bf16).

    Clusters of 8 blocks (the portable size) from 17 images up; below
    that 16 (non-portable, still one cluster per image), so a small batch
    keeps more SMs busy; the bf16 form keeps these sizes (measured per
    stage with ``tools/se_plan_sweep.py --bf16``: with its asynchronous
    exchange no other cluster size, and no other split, was more than 5%
    faster at any stage at B = 32, and one block per image was slower at
    every stage). Split by channels where each block's slice of a row is
    at least 16 channels (64 bytes in f32, so the strided copies stay
    efficient): no block barrier before the FCs, and each weight read once
    per image. Else split by rows, every block running the (then small)
    FCs whole. Resident when a block's part of the image fits its shared
    memory, else streaming. Where the resident clusters would not all fit
    the card at once (stage 1 at 224 px and B = 32: 30 of 32), a block
    keeps fewer rows, so that one more block fits an SM, and streams the
    rest: a second wave of clusters costs more than reading those rows twice.
    """
    if min(b, hw, c, r) <= 0:
        raise ValueError(f"se_plan: sizes must be positive, got b={b} hw={hw} c={c} r={r}")
    if esize not in (2, 4):
        raise ValueError(f"se_plan: esize must be 4 (f32) or 2 (bf16), got {esize}")
    target = 8 if b * 8 > NUM_SMS else 16
    cluster = min(target, c // 4 if c % 4 == 0 else c)
    rows = slice_width(c, cluster, esize) < 16
    if rows:
        cluster = min(target, hw)
    base = _smem_bytes(c, r, cluster, 0, rows, esize)
    if base > MAX_SMEM:
        raise ValueError(
            f"the SE kernel's vectors for C={c}, R={r} need {base} bytes of shared "
            f"memory, more than {MAX_SMEM}")
    full = -(-hw // cluster) if rows else hw
    keep = full if _smem_bytes(c, r, cluster, full, rows, esize) <= MAX_SMEM else 0
    width = c if rows else slice_width(c, cluster, esize)
    while keep:
        slots = SM_SHARED // (_smem_bytes(c, r, cluster, keep, rows, esize) + 1024)
        if CLUSTER_FILL * NUM_SMS * slots / cluster >= b:
            break
        keep = max(0, (SM_SHARED // (slots + 1) - 1024 - base) // (esize * width))
    return SEPlan(cluster, rows, keep, _smem_bytes(c, r, cluster, keep, rows, esize))


def _validate(x, w1, w2) -> None:
    require(x, "x")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got {tuple(x.shape)}")
    c = x.shape[3]
    r = w1.shape[0] if w1.dim() == 2 else -1
    require(w1, "w1", (r, c), x.device, x.dtype)
    require(w2, "w2", (c, r), x.device, x.dtype)
    if r <= 0 or x.numel() == 0:
        raise ValueError(f"the SE kernel takes a non-empty x and r >= 1, got x "
                         f"{tuple(x.shape)} and w1 {tuple(w1.shape)}")


def fused_se(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(relu(mean_hw(x) · w1ᵀ) · w2ᵀ), per image and channel.

    Args:
        x: [B, H, W, C] NHWC f32 or bf16, any C.
        w1: [C/r, C] fc1 weight (nn.Linear layout), x's dtype.
        w2: [C, C/r] fc2 weight (nn.Linear layout), x's dtype.

    Returns:
        [B, H, W, C] NHWC in x's dtype, contiguous.
    """
    _validate(x, w1, w2)
    if x.device.type == "cpu":
        return plain_se(x, w1, w2)
    if x.dtype == torch.bfloat16:
        return _launch(x, w1, w2, "vqa_se_bf16", fused_se_bf16)
    return _launch(x, w1, w2, "vqa_se_f32", fused_se)


def fused_se_bf16(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The bf16 form: x, w1, w2 and the output bf16, f32 inside (the plain
    version on CPU tensors). ``fused_se`` routes bf16 here."""
    _validate(x, w1, w2)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_se_bf16 takes bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return plain_se(x, w1, w2)
    return _launch(x, w1, w2, "vqa_se_bf16", fused_se_bf16)


def _launch(x, w1, w2, launcher: str, counter) -> torch.Tensor:
    b, h, w, c = x.shape
    plan = se_plan(b, h * w, c, w1.shape[0], ESIZE[x.dtype])
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):  # a new thread's current device is 0
        rc = getattr(load_library(), launcher)(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), b, h * w, c,
            w1.shape[0], plan.cluster, plan.keep_rows, int(plan.rows), plan.smem_bytes,
            stream_of(x))
    check(rc, "se")
    count_launch(counter)
    return out


fused_se.launches = 0
fused_se_bf16.launches = 0


def max_active_clusters(plan: SEPlan, hw: int, c: int, r: int, vec: int = 4,
                        esize: int = 4) -> int:
    """How many clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``); ``esize`` 4 is the f32 form, 2
    the bf16 one; ``vec`` 16 // esize is the 16-byte instantiation the
    aligned main path runs, 1 the single-element one."""
    n = ctypes.c_int(0)
    rc = load_library().vqa_se_max_active_clusters(
        hw, c, r, plan.cluster, plan.keep_rows, int(plan.rows), plan.smem_bytes, vec,
        esize, ctypes.byref(n))
    check(rc, "se occupancy query")
    return n.value


def plain_se(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (CPU path and on-card oracle):
    sum over H·W times 1/HW, as the kernel pools. bf16 inputs are computed
    in f32 and the output rounded once to bf16, as the kernel's bf16 form
    does."""
    if x.dtype == torch.bfloat16:
        return plain_se(x.float(), w1.float(), w2.float()).to(torch.bfloat16)
    b, h, w, c = x.shape
    pooled = x.sum(dim=(1, 2)) * (1.0 / (h * w))
    hidden = torch.relu(pooled @ w1.t())
    s = torch.sigmoid(hidden @ w2.t())
    return x * s[:, None, None, :]
