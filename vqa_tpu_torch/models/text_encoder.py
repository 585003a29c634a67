"""Transformer question encoder (pre-norm, hand-rolled MHA).

Counterpart of ``vqa_tpu/models/text_encoder.py``: embeddings scaled by √d,
sinusoidal positional encoding, N pre-norm layers of biasless-projection
multi-head self-attention and a ReLU FFN, a final LayerNorm, and a
masked-mean pooled output.

Parity with the flax modules: every LayerNorm uses eps 1e-6 (flax's
default; torch's is 1e-5); masked scores are filled with -1e9, not -inf;
softmax runs in f32 and its weights return to the compute dtype; the PE
table is added in the compute dtype; pooling divides by the mask count
clipped at 1. The
PE table lives in a persistent ``pe`` buffer [1, L, D] so the reference
state_dict key ``text_encoder.positional_encoding.pe`` loads strictly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from vqa_tpu_torch.models.layers import ComputeCopies, Embedding, LayerNorm, Linear

NEG_INF = -1e9
LN_EPS = 1e-6


def sinusoidal_position_encoding(max_length: int, embed_dim: int) -> np.ndarray:
    """[max_length, embed_dim] sinusoidal table, computed as the JAX package
    computes it (f32 numpy)."""
    pe = np.zeros((max_length, embed_dim), dtype=np.float32)
    position = np.arange(max_length, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, embed_dim, 2, dtype=np.float32)
        * (-math.log(10000.0) / embed_dim)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: embed_dim // 2])
    return pe


class PositionalEncoding(ComputeCopies, nn.Module):
    """Add the sinusoidal table (in the compute dtype, as the JAX module
    casts it), then dropout."""

    copied = ("pe",)

    def __init__(self, embed_dim: int, max_length: int = 512, dropout: float = 0.1):
        super().__init__()
        pe = torch.from_numpy(sinusoidal_position_encoding(max_length, embed_dim))
        self.register_buffer("pe", pe[None], persistent=True)
        self.dropout = nn.Dropout(dropout)
        self.init_copies()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.compute("pe")[:, : x.shape[1]])


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention with biasless W_q/W_k/W_v/W_o and √(d/H)
    scaling."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        # num_heads: this rank's heads under tensor parallelism (shard_model)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        for name in ("W_q", "W_k", "W_v", "W_o"):
            setattr(self, name, Linear(embed_dim, embed_dim, bias=False))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, L, _ = x.shape
        h, dh = self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(b, L, h, dh).transpose(1, 2)

        q, k, v = heads(self.W_q(x)), heads(self.W_k(x)), heads(self.W_v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if attention_mask is not None:
            scores = scores.masked_fill(attention_mask[:, None, None, :] == 0, NEG_INF)
        weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        ctx = torch.matmul(self.dropout(weights), v)
        ctx = ctx.transpose(1, 2).reshape(b, L, h * dh)
        return self.W_o(ctx)


class FeedForwardNetwork(nn.Module):
    """Linear(d→d_ff) → ReLU → Dropout → Linear(d_ff→d)."""

    def __init__(self, embed_dim: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        self.fc1 = Linear(embed_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, embed_dim)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(torch.relu(self.fc1(x))))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm residual layer: LN→MHA→+x, LN→FFN→+x."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_hidden_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.norm1 = LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attention = MultiHeadSelfAttention(embed_dim, num_heads, dropout)
        self.norm2 = LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn = FeedForwardNetwork(embed_dim, ffn_hidden_dim, dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.dropout(self.self_attention(self.norm1(x), attention_mask))
        return x + self.dropout(self.ffn(self.norm2(x)))


class TransformerTextEncoder(nn.Module):
    """embed·√d + sinusoidal PE + N pre-norm layers + final LN; returns
    (sequence [B, L, D], masked-mean pooled [B, D])."""

    def __init__(self, vocab_size: int, embed_dim: int = 256, num_layers: int = 4,
                 num_heads: int = 8, ffn_hidden_dim: int = 1024, max_length: int = 50,
                 dropout: float = 0.1):
        super().__init__()
        self.embed_dim = embed_dim
        self.token_embedding = Embedding(vocab_size, embed_dim)
        self.positional_encoding = PositionalEncoding(embed_dim, max_length, dropout)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, num_heads, ffn_hidden_dim, dropout)
            for _ in range(num_layers)
        )
        self.final_norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.token_embedding(token_ids) * math.sqrt(self.embed_dim)
        x = self.positional_encoding(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        encoded = self.final_norm(x)
        return encoded, masked_mean(encoded, attention_mask)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over dim 1 of [B, L, D], counting only mask != 0 positions; the
    count is clipped at 1 so an all-padding row pools to 0, not NaN."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1)
