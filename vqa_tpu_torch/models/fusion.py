"""Multimodal fusion: image projection → cross-attention → gated pooling.

Counterpart of ``vqa_tpu/models/fusion.py``: project the [B,S,S,C] NHWC
feature map to S·S image tokens at width D (+ learnable position
embeddings), run the stacked cross-attention with the question as query,
masked-mean pool both the attended and the raw text features (count
clipped at 1), combine through a sigmoid gate and LayerNorm the result.

Image tokens are in the order p = h·W + w, the row-major flatten of NHWC
(``fusion.py:41``); the backbone returns NHWC, so the flatten is a view.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from vqa_tpu_torch.models.cross_attention import StackedCrossAttention
from vqa_tpu_torch.models.layers import ComputeCopies, LayerNorm, Linear
from vqa_tpu_torch.models.text_encoder import LN_EPS, masked_mean


class ImageFeatureProjector(ComputeCopies, nn.Module):
    """[B,H,W,C] → [B,H·W,D] via Linear + LN + Dropout, plus learnable
    position embeddings (added in the compute dtype, as ``fusion.py:53``
    casts them)."""

    copied = ("position_embedding",)

    def __init__(self, in_channels: int, embed_dim: int, spatial_size: int = 7,
                 dropout: float = 0.1):
        super().__init__()
        self.projection = nn.Sequential(
            Linear(in_channels, embed_dim),
            LayerNorm(embed_dim, eps=LN_EPS),
            nn.Dropout(dropout),
        )
        self.position_embedding = nn.Parameter(
            torch.zeros(1, spatial_size * spatial_size, embed_dim))
        self.init_copies()

    def forward(self, image_features: torch.Tensor) -> torch.Tensor:
        b, h, w, c = image_features.shape
        x = self.projection(image_features.reshape(b, h * w, c))
        return x + self.compute("position_embedding")[:, : h * w]


class GatingMechanism(nn.Module):
    """g = σ(Linear([x; y])); out = g·x + (1−g)·y."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.gate = nn.Sequential(Linear(2 * embed_dim, embed_dim), nn.Sigmoid())

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        g = self.gate(torch.cat([x, y], dim=-1))
        return g * x + (1 - g) * y


class MultimodalFusion(nn.Module):
    """image [B,7,7,512] → tokens [B,49,256]; text [B,20,256] → attended
    [B,20,256]; pooled, gated and normed → fused [B,256]."""

    def __init__(self, image_channels: int = 512, image_spatial_size: int = 7,
                 embed_dim: int = 256, num_heads: int = 8, num_cross_layers: int = 2,
                 dropout: float = 0.1, use_gating: bool = True):
        super().__init__()
        self.image_projector = ImageFeatureProjector(
            image_channels, embed_dim, image_spatial_size, dropout)
        self.cross_attention = StackedCrossAttention(
            embed_dim, num_heads, num_cross_layers, dropout)
        self.gate = GatingMechanism(embed_dim) if use_gating else None
        self.output_norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, image_features: torch.Tensor, text_features: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        image_projected = self.image_projector(image_features)
        # all image positions are valid: no key/value mask
        cross_attended, attention_weights = self.cross_attention(
            text_features, image_projected)
        attended_pooled = masked_mean(cross_attended, text_mask)
        text_pooled = masked_mean(text_features, text_mask)
        if self.gate is not None:
            fused = self.gate(attended_pooled, text_pooled)
        else:
            fused = attended_pooled + text_pooled
        fused = self.output_norm(fused)
        aux = {
            "cross_attention_weights": attention_weights,
            "image_projected": image_projected,
            "attended_pooled": attended_pooled,
            "text_pooled": text_pooled,
        }
        return fused, aux


def attention_visualization(attention_weights: List[torch.Tensor],
                            spatial_size: int = 7) -> torch.Tensor:
    """Average per-layer [B,H,L_q,L_kv] weights over layers and heads and
    reshape to [B, L_q, S, S]."""
    avg = torch.stack(attention_weights, dim=0).mean(dim=0).mean(dim=1)
    b, lq, _ = avg.shape
    return avg.reshape(b, lq, spatial_size, spatial_size)
