"""The least time each of the port's kernels could take, per forward.

Copied from `chip_smoke.py`'s kernel checks (`check_kernels`,
`check_kernels_bf16`, `bound_ms`, `bound16_ms`), so that a kernel's roofline
reads the same work whatever implements it. For each kernel: the bytes it
has to move (each input read once, each output written once, in the
form's element size) and the operations it has to do; its bound is the
larger of bytes / 3.35 TB/s and operations / the form's peak (bf16: 989
TFLOP/s on the tensor cores; the f32 stem: 3xTF32, three TF32 products per
product at 495 TFLOP/s; the f32 SE and cross-attention: 67 TFLOP/s).

`forward_bounds(cfg, batch, dtype)` returns, per kernel family, the names
of the kernel functions that make its launches (compared whole with the
function's name in a profiler trace, `harness/trace.py:kernel_base`; a
forward runs the forms of one dtype only), the launches one forward makes,
and the bound of those launches together in seconds. Where a family's
launches do not come in that number per forward in a trace, the share is
not read (`metrics/kernels_roofline.py`).
"""

from __future__ import annotations

from typing import Dict

from benchmark.costs.flops import conv_out
from benchmark.costs.peaks import (BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                   TF32_FLOP_PER_S)


def bound_s(nbytes: float, flops: float, flop_per_s: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)


def stem_bound(cfg: dict, b: int, bf16: bool) -> float:
    """7x7/2 conv + folded BN + ReLU + 3x3/2 max pool over [b, S, S, 3]."""
    s, cout = cfg["image_size"], cfg["stage_channels"][0]
    ch = conv_out(s, 7, 2, 3)
    po = conv_out(ch, 3, 2, 1)
    x, w, out = b * s * s * 3, cout * 3 * 49, b * po * po * cout
    conv = 2 * b * ch * ch * cout * 147
    if bf16:
        return bound_s(2 * (x + w + out) + 8 * cout, conv, BF16_FLOP_PER_S)
    return bound_s(4 * (x + w + 2 * cout + out), 3 * conv, TF32_FLOP_PER_S)


def se_stage_shapes(cfg: dict):
    """(H*W, C, R) of each stage's SE at the configuration's image size."""
    h = conv_out(conv_out(cfg["image_size"], 7, 2, 3), 3, 2, 1)
    out = []
    for i, c in enumerate(cfg["stage_channels"], start=1):
        if i > 1:
            h = conv_out(h, 3, 2, 1)
        out.append((h * h, c, max(c // cfg["se_reduction"], 1)))
    return out


def se_bound(cfg: dict, b: int, bf16: bool) -> float:
    """Every stage's SE: read x, write x * s, read both FCs; pool, FCs,
    scale."""
    esize, peak = (2, BF16_FLOP_PER_S) if bf16 else (4, F32_FLOP_PER_S)
    total = 0.0
    for hw, c, r in se_stage_shapes(cfg):
        n = b * hw * c
        total += bound_s(esize * (2 * n + 2 * c * r), 2 * n + 4 * b * c * r + 4 * b * c, peak)
    return total


def cross_attention_bound(cfg: dict, b: int, bf16: bool) -> float:
    """The attention core of every fusion layer: read q, k, v, write the
    context and the probabilities."""
    esize, peak = (2, BF16_FLOP_PER_S) if bf16 else (4, F32_FLOP_PER_S)
    heads, d = cfg["num_attention_heads"], cfg["embed_dim"]
    lq, lkv = cfg["max_question_length"], cfg["feature_spatial_size"] ** 2
    dh = d // heads
    q, kv, w = b * lq * d, b * lkv * d, b * heads * lq * lkv
    nbytes = esize * (2 * q + 2 * kv + w)
    flops = 4 * b * heads * lq * lkv * dh + 5 * w
    return cfg["num_cross_layers"] * bound_s(nbytes, flops, peak)


def forward_bounds(cfg: dict, batch: int, dtype: str) -> Dict[str, dict]:
    """Per kernel family of one forward of `batch` pairs in `dtype`
    ("bfloat16" or "float32"): {"names", "launches", "bound_s"}."""
    bf16 = dtype == "bfloat16"
    out = {
        "stem": dict(names=("stem_kernel_bf16",) if bf16 else ("stem_kernel",),
                     launches=1, bound_s=stem_bound(cfg, batch, bf16)),
        "cross_attention": dict(
            names=("cross_attention_bf16",) if bf16 else ("cross_attention_kernel",),
            launches=cfg["num_cross_layers"], bound_s=cross_attention_bound(cfg, batch, bf16)),
    }
    if cfg["use_se_attention"]:
        out["se"] = dict(names=("se_bf16",) if bf16 else ("se_cluster",),
                         launches=len(cfg["stage_channels"]), bound_s=se_bound(cfg, batch, bf16))
    return out
