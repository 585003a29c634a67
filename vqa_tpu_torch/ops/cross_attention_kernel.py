"""Cross-attention core: softmax(Q·Kᵀ/scale)·V, returning context and weights.

Counterpart of ``vqa_tpu/ops/cross_attention_kernel.py``.
``fused_cross_attention`` launches the hand-written CUDA kernel
``csrc/cross_attention.cu`` on CUDA tensors and computes
``plain_cross_attention`` on CPU tensors. Layout [B, H, L, d] as in the
JAX package. f32 inputs give f32 outputs; bf16 inputs launch the bf16
form's own kernel (``fused_cross_attention_bf16``), which stages q, k and
v as bf16 by asynchronous copies, computes in f32 in the f32 form's order
and writes both outputs in bf16 with 16-byte stores, as the Pallas kernel
computes bf16 blocks in f32 and casts its outputs once.
Its launch geometry (one slice per block, shared-memory layout, the
shapes it refuses) is mirrored here by ``bf16_geometry``.

q, k and v may be strided views — the model passes head-transposed views
of its [B, L, H, d] projections — as long as the last dimension has unit
stride. On the card the context is written into [B, L_q, H, d] memory and
returned as its [B, H, L_q, d] view, so the model's merge of the heads
costs no copy; the weights are contiguous [B, H, L_q, L_kv].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vqa_tpu_torch.ops._build import check, check_dtype, count_launch, load_library, stream_of

MAX_D = 128       # head width the kernel takes
MAX_LKV = 256     # keys per slice the kernel takes
MAX_SMEM = 227 * 1024


def smem_bytes(lq: int, lkv: int, d: int) -> int:
    """Shared memory of one f32 block: Q, K (odd float4 row stride) and V,
    the keys zero-padded to a multiple of 32 (as ``csrc/cross_attention.cu``)."""
    d4 = -(-d // 4)
    nkeys = 32 * -(-lkv // 32)
    return 16 * (lq * d4 + nkeys * (d4 | 1) + nkeys * d4)


ROWS16 = 2        # bf16 form: query rows a warp holds at once
MAX_WARPS16 = 16  # warps per block (one slice per block)


def _round16(v: int) -> int:
    return (v + 15) & ~15


class Geometry16(NamedTuple):
    warps: int       # warps per block (one (batch, head) slice)
    threads: int     # threads per block
    smem_bytes: int  # dynamic shared memory per block
    blocks: int      # blocks of the launch: one per slice


def bf16_geometry(bh: int, lq: int, lkv: int, d: int) -> Geometry16:
    """The bf16 form's launch for ``bh`` (batch·head) slices, one per block
    of ``ceil(lq / 2)`` warps (at most 16, which then loop over the rows),
    and its shared memory (``csrc/cross_attention.cu``, ``Geometry16``): q,
    k (rows 16 bytes wider) and v as bf16, and for each warp its rows' f32
    probabilities, staged weights (16 bytes more, to shift them to their
    destination's alignment) and context rows. Raises ValueError for a
    shape the kernel refuses: d > 128, L_kv > 256, or beyond 227 KB of
    shared memory."""
    if min(bh, lq, lkv, d) <= 0 or d > MAX_D or lkv > MAX_LKV:
        raise ValueError(
            f"the bf16 cross-attention kernel takes d <= {MAX_D} and L_kv <= {MAX_LKV}, "
            f"got L_q={lq}, L_kv={lkv}, d={d}")
    warps = min(MAX_WARPS16, -(-lq // ROWS16))
    ldq = -(-d // 8) * 8
    per_warp = (_round16(4 * lkv * ROWS16) + _round16(2 * ROWS16 * lkv + 16)
                + _round16(2 * ROWS16 * ldq))
    smem = (_round16(2 * lq * ldq) + _round16(2 * lkv * (ldq + 8)) + _round16(2 * lkv * ldq)
            + warps * per_warp)
    if smem > MAX_SMEM:
        raise ValueError(
            f"the bf16 cross-attention kernel needs {smem} bytes of shared memory for "
            f"L_q={lq}, L_kv={lkv}, d={d}, more than {MAX_SMEM}")
    return Geometry16(warps, 32 * warps, smem, bh)


def _validate(q, k, v) -> None:
    """Checks shared by the CPU and CUDA paths."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        check_dtype(t, name, q.dtype if name != "q" else None)
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B,H,L,d], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(
                f"{name} must have a contiguous last dimension (unit stride), "
                f"got strides {t.stride()}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q is on {q.device}: the kernels take CPU or CUDA tensors")
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, lkv, d):
            raise ValueError(f"{name} must have shape {(b, h, lkv, d)}, got {tuple(t.shape)}")
    if q.dtype == torch.bfloat16:
        bf16_geometry(b * h, lq, lkv, d)
    elif d > MAX_D or lkv > MAX_LKV or smem_bytes(lq, lkv, d) > MAX_SMEM:
        raise ValueError(
            f"the cross-attention kernel takes d <= {MAX_D} and L_kv <= {MAX_LKV} within "
            f"{MAX_SMEM} bytes of shared memory, got L_q={lq}, L_kv={lkv}, d={d}")


def fused_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention core with the probabilities.

    Args:
        q: [B, H, L_q, d] queries, f32 or bf16.
        k, v: [B, H, L_kv, d] keys / values, q's dtype.
        scale: divisor of the scores (√d).

    Returns:
        (context [B, H, L_q, d], weights [B, H, L_q, L_kv]) in q's dtype;
        on the card the context is a view of [B, L_q, H, d] memory.
    """
    _validate(q, k, v)
    if q.device.type == "cpu":
        return plain_cross_attention(q, k, v, scale)
    if q.dtype == torch.bfloat16:
        return _launch(q, k, v, scale, "vqa_cross_attention_bf16", fused_cross_attention_bf16)
    return _launch(q, k, v, scale, "vqa_cross_attention_f32", fused_cross_attention)


def fused_cross_attention_bf16(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 form: q, k, v and both outputs bf16, f32 inside (the plain
    version on CPU tensors). ``fused_cross_attention`` routes bf16 here."""
    _validate(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"fused_cross_attention_bf16 takes bfloat16, got {q.dtype}")
    if q.device.type == "cpu":
        return plain_cross_attention(q, k, v, scale)
    return _launch(q, k, v, scale, "vqa_cross_attention_bf16", fused_cross_attention_bf16)


def _launch(q, k, v, scale, launcher: str, counter):
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    ctx = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    w = torch.empty((b, h, lq, lkv), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, ctx) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):  # a new thread's current device is 0
        rc = getattr(load_library(), launcher)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(), w.data_ptr(),
            b, h, lq, lkv, d, *strides, 1.0 / scale, stream_of(q))
    check(rc, "cross_attention")
    count_launch(counter)
    return ctx, w


fused_cross_attention.launches = 0
fused_cross_attention_bf16.launches = 0


def plain_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch ops (CPU path and on-card oracle).
    bf16 inputs are computed in f32 and both outputs rounded once to bf16,
    as the kernel's bf16 form does."""
    if q.dtype == torch.bfloat16:
        ctx, w = plain_cross_attention(q.float(), k.float(), v.float(), scale)
        return ctx.to(torch.bfloat16), w.to(torch.bfloat16)
    scores = torch.matmul(q, k.transpose(-1, -2)) / scale
    w = torch.softmax(scores.float(), dim=-1)
    return torch.matmul(w, v), w
