"""ResNet-18-style CNN backbone with SE + spatial attention.

Counterpart of ``vqa_tpu/models/cnn_backbone.py:171-347``: stem (7×7/2
conv + BN + ReLU + 3×3/2 maxpool) → 4 stages of residual blocks
(64→128→256→512 at full width), SE attention in every stage, spatial
attention in stages 3-4.

Layout: the model takes NHWC images and returns NHWC features, as the JAX
backbone does; inside, tensors are NCHW in ``torch.channels_last`` memory,
so the NHWC views the stem and SE kernels read cost no copy. In eval mode,
where the stem kernel takes the geometry (``stem_kernel.stem_takes``: 3
input channels, a multiple of 8 up to 64 features), the stem runs as one
fused kernel (``ops/stem_kernel.py``) with BN folded into a per-channel
affine, as ``cnn_backbone.py:294-308`` gates and folds it; otherwise, and
in training mode, it runs conv → BN → ReLU → maxpool.

Parameter names follow the reference state_dict layout (``stem.0`` conv,
``stem.1`` BN, ``stageN.blocks.i.conv1`` …, ``downsample.0/1``). BN uses
eps 1e-5 and momentum 0.1, as the JAX package's ``BN_EPS`` and
``BN_MOMENTUM`` (keep-fraction 0.9) do, and in training mode updates its
running variance with the biased batch variance, as flax's ``BatchNorm``
does (``BatchNorm2d`` below).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqa_tpu_torch.models.attention_modules import AttentionWrapper
from vqa_tpu_torch.ops import stem_kernel

BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running variance is the
    biased batch variance, as flax's ``BatchNorm`` keeps it; torch's own
    takes the unbiased one, which after one step at batch 4 moved a
    stage-4 ``running_var`` by ~1e-2 from flax's. Normalisation, the eval
    path and the state_dict keys are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class ResidualBlock(nn.Module):
    """3×3 conv→BN→ReLU→3×3 conv→BN (+1×1 conv+BN shortcut on shape
    change), add, ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(out_channels, eps=BN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(out_channels, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride, 0, bias=False),
                BatchNorm2d(out_channels, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResidualStage(nn.Module):
    """N residual blocks (the first may stride 2), then the attention wrapper."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 2,
                 stride: int = 1, use_se: bool = True, use_spatial: bool = True,
                 se_reduction: int = 16):
        super().__init__()
        self.blocks = nn.ModuleList(
            [ResidualBlock(in_channels, out_channels, stride)]
            + [ResidualBlock(out_channels, out_channels, 1) for _ in range(1, num_blocks)]
        )
        self.attention = AttentionWrapper(
            out_channels, use_se=use_se, use_spatial=use_spatial,
            se_reduction=se_reduction,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.attention(x)


class CustomResNet(nn.Module):
    """Backbone: [B, S, S, 3] NHWC → [B, S/32, S/32, C4] NHWC.

    At full width: stem [B,56,56,64] → stage1 [B,56,56,64] → stage2
    [B,28,28,128] → stage3 [B,14,14,256] → stage4 [B,7,7,512].
    """

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 stage_channels: Sequence[int] = None,
                 num_blocks: Sequence[int] = (2, 2, 2, 2), use_se: bool = True,
                 use_spatial: bool = True, se_reduction: int = 16):
        super().__init__()
        c = list(stage_channels or [base_channels * m for m in (1, 2, 4, 8)])
        self.output_channels = c[-1]
        self.stem = nn.Sequential(
            nn.Conv2d(in_channels, c[0], 7, 2, 3, bias=False),
            BatchNorm2d(c[0], eps=BN_EPS),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
        )
        # spatial attention only in stages 3-4
        specs = [(c[0], c[0], 1, False), (c[0], c[1], 2, False),
                 (c[1], c[2], 2, use_spatial), (c[2], c[3], 2, use_spatial)]
        for i, (cin, cout, stride, spatial) in enumerate(specs, start=1):
            self.add_module(f"stage{i}", ResidualStage(
                cin, cout, num_blocks[i - 1], stride, use_se, spatial, se_reduction))

    def _fused_stem(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        conv, bn = self.stem[0], self.stem[1]
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * scale
        out = stem_kernel.fused_stem(x_nhwc.contiguous(), conv.weight, scale, bias)
        return out.permute(0, 3, 1, 2)  # NCHW view of NHWC memory

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        conv = self.stem[0]
        if self.training or not stem_kernel.stem_takes(conv.in_channels, conv.out_channels):
            x = self.stem(x_nhwc.permute(0, 3, 1, 2))
        else:
            x = self._fused_stem(x_nhwc)
        for i in range(1, 5):
            x = getattr(self, f"stage{i}")(x)
        return x.permute(0, 2, 3, 1)  # NHWC, as the JAX backbone returns
