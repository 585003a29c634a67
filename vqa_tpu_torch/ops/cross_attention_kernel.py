"""Cross-attention core: softmax(Q·Kᵀ/scale)·V, returning context and weights.

Counterpart of ``vqa_tpu/ops/cross_attention_kernel.py``.
``fused_cross_attention`` launches the hand-written CUDA kernel
``csrc/cross_attention.cu`` on CUDA tensors and computes
``plain_cross_attention`` on CPU tensors. Layout [B, H, L, d] as in the
JAX package; f32 throughout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqa_tpu_torch.ops._build import check, load_library, require, stream_of


def _validate(q, k, v) -> None:
    require(q, "q")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"q, k, v must be [B,H,L,d], got {tuple(q.shape)}, {tuple(k.shape)}")
    b, h, _, d = q.shape
    lkv = k.shape[2]
    require(k, "k", (b, h, lkv, d), q.device)
    require(v, "v", (b, h, lkv, d), q.device)


def fused_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention core with the probabilities.

    Args:
        q: [B, H, L_q, d] queries.
        k, v: [B, H, L_kv, d] keys / values.
        scale: divisor of the scores (√d).

    Returns:
        (context [B, H, L_q, d], weights [B, H, L_q, L_kv])
    """
    _validate(q, k, v)
    if q.device.type == "cpu":
        return plain_cross_attention(q, k, v, scale)
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    ctx = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    w = torch.empty((b, h, lq, lkv), dtype=torch.float32, device=q.device)
    rc = load_library().vqa_cross_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(), w.data_ptr(),
        b * h, lq, lkv, d, 1.0 / scale, stream_of(q))
    check(rc, "cross_attention")
    fused_cross_attention.launches += 1
    return ctx, w


fused_cross_attention.launches = 0


def plain_cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch ops (CPU path and on-card oracle)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / scale
    w = torch.softmax(scores.float(), dim=-1)
    return torch.matmul(w, v), w
