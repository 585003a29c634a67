"""Cross-attention (text queries attend to image tokens).

Counterpart of ``vqa_tpu/models/cross_attention.py``: biasless Q/K/V/O
projections, √(d/H) scaling, pre-norm on query and key/value (LayerNorm eps
1e-6, flax's default), residuals, a 4d FFN, stacked N=2 with per-layer
attention weights.

In eval mode with no key/value mask — the condition of the JAX code at
``cross_attention.py:63`` — the attention core runs as the cross-attention
kernel (``ops/cross_attention_kernel.py``), which reads the head-transposed
projections as strided views and writes the context head-merged, so neither
side makes a copy; in training mode, or with a mask, it runs as matmul →
masked fill (-1e9) → f32 softmax (cast back to the compute dtype) →
dropout → matmul, as the JAX einsum path does. In bf16 the kernel's bf16
form returns bf16 context and weights, as the Pallas kernel does.

Parameter names follow the reference state_dict layout
(``layers.i.cross_attention.W_q``, ``layers.i.ffn.0`` / ``ffn.3``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from vqa_tpu_torch.models.layers import LayerNorm, Linear
from vqa_tpu_torch.ops import cross_attention_kernel

NEG_INF = -1e9
LN_EPS = 1e-6


class CrossAttention(nn.Module):
    """Attention core: Q from text, K/V from image."""

    def __init__(self, embed_dim: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        for name in ("W_q", "W_k", "W_v", "W_o"):
            setattr(self, name, Linear(embed_dim, embed_dim, bias=False))
        self.dropout = nn.Dropout(dropout)

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_value_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, lq, _ = query.shape
        lkv = key_value.shape[1]
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        scale = math.sqrt(dh)

        def heads(t, L):  # [B,H,L,dh] view of [B,L,H,dh] memory, no copy
            return t.reshape(b, L, h, dh).transpose(1, 2)

        q = heads(self.W_q(query), lq)
        k = heads(self.W_k(key_value), lkv)
        v = heads(self.W_v(key_value), lkv)

        if not self.training and key_value_mask is None:
            ctx, weights = cross_attention_kernel.fused_cross_attention(q, k, v, scale)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / scale
            if key_value_mask is not None:
                scores = scores.masked_fill(
                    key_value_mask[:, None, None, :] == 0, NEG_INF)
            weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
            ctx = torch.matmul(self.dropout(weights), v)

        # the kernel's context is a view of [B,Lq,H,dh] memory: no copy here
        ctx = ctx.transpose(1, 2).reshape(b, lq, self.embed_dim)
        return self.W_o(ctx), weights


class MultiHeadCrossAttention(nn.Module):
    """Pre-norm (query and kv) + residual + FFN (hidden 4d)."""

    def __init__(self, embed_dim: int, num_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        hidden = 4 * embed_dim
        self.norm_query = LayerNorm(embed_dim, eps=LN_EPS)
        self.norm_kv = LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attention = CrossAttention(embed_dim, num_heads, dropout)
        self.dropout = nn.Dropout(dropout)
        self.norm_ffn = LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn = nn.Sequential(
            Linear(embed_dim, hidden), nn.ReLU(), nn.Dropout(dropout),
            Linear(hidden, embed_dim), nn.Dropout(dropout),
        )

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_value_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        attended, weights = self.cross_attention(
            self.norm_query(query), self.norm_kv(key_value), key_value_mask)
        query = query + self.dropout(attended)
        query = query + self.ffn(self.norm_ffn(query))
        return query, weights


class StackedCrossAttention(nn.Module):
    """N cross-attention blocks, the query refined layer to layer."""

    def __init__(self, embed_dim: int, num_heads: int = 8, num_layers: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            MultiHeadCrossAttention(embed_dim, num_heads, dropout)
            for _ in range(num_layers)
        )

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                key_value_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        all_weights = []
        for layer in self.layers:
            query, w = layer(query, key_value, key_value_mask)
            all_weights.append(w)
        return query, all_weights
