"""Squeeze-and-Excitation: pool → FC → ReLU → FC → sigmoid → rescale.

Counterpart of ``vqa_tpu/ops/se_kernel.py``. ``fused_se`` launches the
hand-written CUDA kernels of ``csrc/se.cu`` (a pooled reduction, then the
FCs and sigmoid fused with the rescale pass) on a CUDA tensor and computes
``plain_se`` on a CPU tensor. x is NHWC as in the JAX package; the weights
are the ``nn.Linear`` layouts ``SEAttention`` stores ([out, in]), the
transposes of the flax kernels ``fused_se`` of the JAX package takes.
"""

from __future__ import annotations

import torch

from vqa_tpu_torch.ops._build import check, load_library, require, stream_of

MAX_C = 1024
# floats of x one block handles (~32 KB): keeps hundreds of blocks in
# flight at stage-1 sizes
_CHUNK_FLOATS = 8192


def _validate(x, w1, w2) -> None:
    require(x, "x")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C], got {tuple(x.shape)}")
    c = x.shape[3]
    if c % 4 or c > MAX_C:
        raise ValueError(f"the SE kernel takes C a multiple of 4 up to {MAX_C}, got {c}")
    r = w1.shape[0] if w1.dim() == 2 else -1
    require(w1, "w1", (r, c), x.device)
    require(w2, "w2", (c, r), x.device)


def fused_se(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(relu(mean_hw(x) · w1ᵀ) · w2ᵀ), per image and channel.

    Args:
        x: [B, H, W, C] NHWC f32.
        w1: [C/r, C] fc1 weight (nn.Linear layout).
        w2: [C, C/r] fc2 weight (nn.Linear layout).

    Returns:
        [B, H, W, C] NHWC, contiguous.
    """
    _validate(x, w1, w2)
    if x.device.type == "cpu":
        return plain_se(x, w1, w2)
    if x.data_ptr() % 16:
        raise ValueError("the SE kernel reads x as float4: x must be 16-byte aligned")
    b, h, w, c = x.shape
    hw = h * w
    rows = max(1, _CHUNK_FLOATS // c)
    nchunks = -(-hw // rows)
    partial = torch.empty((b, nchunks, c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rc = load_library().vqa_se_f32(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, hw, c, w1.shape[0], rows, nchunks, stream_of(x))
    check(rc, "se")
    fused_se.launches += 1
    return out


fused_se.launches = 0


def plain_se(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (CPU path and on-card oracle):
    sum over H·W times 1/HW, as the kernel pools."""
    b, h, w, c = x.shape
    pooled = x.sum(dim=(1, 2)) * (1.0 / (h * w))
    hidden = torch.relu(pooled @ w1.t())
    s = torch.sigmoid(hidden @ w2.t())
    return x * s[:, None, None, :]
