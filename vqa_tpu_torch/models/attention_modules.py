"""CNN attention modules: SE and spatial attention, and their wrapper.

Counterpart of ``vqa_tpu/models/attention_modules.py:37-94,142-161``.
Modules take and return NCHW tensors in ``torch.channels_last`` memory, so
an NHWC view of the same memory is free. In eval mode ``SEAttention`` calls
the SE kernel (``ops/se_kernel.py``) on its own ``fc1`` / ``fc2`` weights
in the compute dtype (the bf16 form on a bf16 model) —
the JAX model computes the same function unfused. ``CBAMBlock`` and
``SelfAttention2D`` are off the serving path and not ported yet.

Parameter names follow the reference state_dict layout
(``attention.se.fc1.weight``, ``attention.spatial.conv.weight``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vqa_tpu_torch.models.layers import Conv2d, Linear
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
