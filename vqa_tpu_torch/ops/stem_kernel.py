"""Fused CNN stem: conv 7x7/2 + BN-eval affine + ReLU + maxpool 3x3/2.

Counterpart of ``vqa_tpu/ops/stem_kernel.py``. ``fused_stem`` launches the
hand-written CUDA kernel ``csrc/stem.cu`` on a CUDA tensor — the conv as an
implicit GEMM on the tensor cores in 3xTF32, which keeps f32 accuracy; the
conv output never reaches device memory — and computes ``plain_stem`` on a
CPU tensor.
Activations are NHWC as in the JAX package; the conv weight is the
``nn.Conv2d`` OIHW layout the model stores, read by the kernel as it is.

Shapes: x [B, H, W, 3] → [B, PH, PW, cout] with CH = ceil(H/2) conv rows
and PH = ceil(CH/2) pool rows (224 → 112 → 56). Any H, W; 3 input
channels and cout a multiple of 8 up to 64 (``stem_takes``). Everything
else raises; the backbone routes other stems to its unfused layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vqa_tpu_torch.ops._build import check, load_library, require, stream_of

MAX_COUT = 64


def stem_output_hw(h: int, w: int):
    """Pool output size of the stem for an H x W input."""
    ch, cw = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (ch - 1) // 2 + 1, (cw - 1) // 2 + 1


def stem_takes(in_channels: int, cout: int) -> bool:
    """Whether the stem kernel takes this geometry: 3 input channels and
    cout a multiple of 8 up to 64."""
    return in_channels == 3 and 0 < cout <= MAX_COUT and cout % 8 == 0


def _validate(x, w, scale, bias) -> None:
    require(x, "x")
    cout = w.shape[0] if w.dim() == 4 else -1
    if x.dim() != 4 or not stem_takes(x.shape[3], cout):
        raise ValueError(
            f"the stem kernel takes NHWC x [B,H,W,3] and cout a multiple of 8 up to "
            f"{MAX_COUT}, got x {tuple(x.shape)} and weight {tuple(w.shape)}")
    require(w, "w", (cout, 3, 7, 7), x.device)
    require(scale, "scale", (cout,), x.device)
    require(bias, "bias", (cout,), x.device)


def fused_stem(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """relu(conv7x7/2(x, w) * scale + bias), then maxpool 3x3/2 pad 1.

    Args:
        x: [B, H, W, 3] NHWC f32 (normalized pixels).
        w: [cout, 3, 7, 7] OIHW conv weight.
        scale: [cout] folded BN scale, gamma / sqrt(var + eps).
        bias: [cout] folded BN bias, beta - mean * scale.

    Returns:
        [B, PH, PW, cout] NHWC, contiguous.
    """
    _validate(x, w, scale, bias)
    if x.device.type == "cpu":
        return plain_stem(x, w, scale, bias)
    b, h, wd, _ = x.shape
    cout = w.shape[0]
    ph, pw = stem_output_hw(h, wd)
    out = torch.empty((b, ph, pw, cout), dtype=torch.float32, device=x.device)
    rc = load_library().vqa_stem_f32(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, wd, cout, stream_of(x))
    check(rc, "stem")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


def plain_stem(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (CPU path and on-card oracle)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()
