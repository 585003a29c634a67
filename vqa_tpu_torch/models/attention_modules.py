"""CNN attention modules: SE, spatial attention, CBAM, 2D self-attention.

Counterpart of ``vqa_tpu/models/attention_modules.py:37-161``. Modules take
and return NCHW tensors in ``torch.channels_last`` memory, so an NHWC view
of the same memory is free. In eval mode ``SEAttention`` calls the SE
kernel (``ops/se_kernel.py``) on its own ``fc1`` / ``fc2`` weights in the
compute dtype (the bf16 form on a bf16 model) — the JAX model computes the
same function unfused.

``CBAMBlock`` and ``SelfAttention2D`` are not on the model's path (nor are
they in the JAX model's); each can be used alone, as the root of its own
compute dtype (``set_compute_dtype``, ``models/layers.py``). A ``CBAMBlock``
in eval mode launches the SE kernel once per call. ``SelfAttention2D``'s
product over H·W pixels is ``torch.matmul``: the JAX package computes it
outside any Pallas kernel too.

Parameter names follow the reference state_dict layout
(``attention.se.fc1.weight``, ``attention.spatial.conv.weight``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from vqa_tpu_torch.models.layers import ComputeDtypeRoot, Conv2d, Linear
from vqa_tpu_torch.ops import se_kernel


class SEAttention(nn.Module):
    """Squeeze-and-Excitation: global average pool → biasless C → C/r → C
    bottleneck → sigmoid → per-channel scale."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        reduced = max(channels // reduction, 1)
        self.fc1 = Linear(channels, reduced, bias=False)
        self.fc2 = Linear(reduced, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        w1, w2 = self.fc1.compute("weight"), self.fc2.compute("weight")
        if self.training:
            out = se_kernel.plain_se(nhwc, w1, w2)
        else:
            out = se_kernel.fused_se(nhwc, w1, w2)
        return out.permute(0, 3, 1, 2)


class SpatialAttention(nn.Module):
    """Channel-max ‖ channel-mean → 7×7 conv (2→1, no bias) → sigmoid mask."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be odd")
        self.conv = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        max_pool = x.amax(dim=1, keepdim=True)
        avg_pool = x.mean(dim=1, keepdim=True)
        attn = self.conv(torch.cat([max_pool, avg_pool], dim=1))
        return x * torch.sigmoid(attn)


class CBAMBlock(ComputeDtypeRoot):
    """SE then spatial attention, in sequence."""

    def __init__(self, channels: int, reduction: int = 16, spatial_kernel: int = 7):
        super().__init__()
        self.se = SEAttention(channels, reduction)
        self.spatial = SpatialAttention(spatial_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial(self.se(x))


class SelfAttention2D(ComputeDtypeRoot):
    """Non-local self-attention over the H·W pixels with a learnable-γ
    residual: ``γ · softmax(q·kᵀ/√(C/r))·v + x``, where q, k, v are biased
    1×1 convs to C/r, C/r and C channels and γ starts at 0."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.reduced = channels // reduction
        self.query = Conv2d(channels, self.reduced, 1)
        self.key = Conv2d(channels, self.reduced, 1)
        self.value = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = x.contiguous(memory_format=torch.channels_last)

        def pixels(t):  # [B, C', H, W] channels_last → [B, H·W, C']
            return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

        q, k, v = pixels(self.query(x)), pixels(self.key(x)), pixels(self.value(x))
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(self.reduced), dim=-1)
        out = (attn @ v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.gamma.to(x.dtype) * out + x


class AttentionWrapper(nn.Module):
    """SE and/or spatial attention — the ``--no-attention`` ablation switch."""

    def __init__(self, channels: int, use_se: bool = True, use_spatial: bool = True,
                 se_reduction: int = 16, spatial_kernel: int = 7):
        super().__init__()
        self.se = SEAttention(channels, se_reduction) if use_se else None
        self.spatial = SpatialAttention(spatial_kernel) if use_spatial else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.se is not None:
            x = self.se(x)
        if self.spatial is not None:
            x = self.spatial(x)
        return x
