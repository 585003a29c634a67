"""Operations of the VQA forward per pair, from a configuration's widths.

Derived from `vqa_tpu_torch/tools/roofline.py`'s accounting (which fixes
the full-width geometry as constants and counts activations only), made a
function of the configuration: the image size, the stem and stage widths,
the blocks per stage, SE (its two FCs, at the stage's reduction), spatial
attention (its 7x7 conv, 2 -> 1, stages 3 and 4), the text encoder, fusion,
the gate and the answer head each follow the configuration's own keys, so
the configuration without attention counts no SE and no spatial attention.

What is counted: every multiply-add of a convolution, a linear layer and an
attention product, as 2 operations: the work the tensor cores could do.
What is left out, by design, because none of it is a product: BatchNorm
and LayerNorm, ReLU and sigmoid, the residual adds, the max pool, SE's and
spatial attention's pooling and scaling, softmax, masking and the masked
means, the embedding lookup and the positional adds, /255 and the ImageNet
normalize. `tests/test_bench_costs.py` holds this count to
`torch.utils.flop_counter.FlopCounterMode` on a CPU forward of the plain
reference at full width, which counts the same products.
"""

from __future__ import annotations

from typing import Dict


def conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def forward_flops(cfg: dict) -> Dict[str, float]:
    """Operations per pair of one forward, by part; `total` sums them."""
    s, c = cfg["image_size"], list(cfg["stage_channels"])
    parts: Dict[str, float] = {}
    h = conv_out(s, 7, 2, 3)
    parts["stem"] = 2 * h * h * 49 * cfg["in_channels"] * c[0]
    h = conv_out(h, 3, 2, 1)  # max pool
    cin = c[0]
    for i, cout in enumerate(c, start=1):
        stride = 1 if i == 1 else 2
        f = 0
        for b in range(cfg["blocks_per_stage"][i - 1]):
            st = stride if b == 0 else 1
            ho = conv_out(h, 3, st, 1)
            bin_ = cin if b == 0 else cout
            f += 2 * ho * ho * 9 * bin_ * cout + 2 * ho * ho * 9 * cout * cout
            if b == 0 and (st != 1 or cin != cout):
                f += 2 * ho * ho * bin_ * cout
            h = ho
        parts[f"stage{i}"] = f
        if cfg["use_se_attention"]:
            r = max(cout // cfg["se_reduction"], 1)
            parts[f"stage{i}.se"] = 2 * 2 * cout * r
        if i >= 3 and cfg["use_spatial_attention"]:
            k = cfg["spatial_kernel_size"]
            parts[f"stage{i}.spatial"] = 2 * h * h * k * k * 2
        cin = cout
    d, L, ffn = cfg["embed_dim"], cfg["max_question_length"], cfg["ffn_hidden_dim"]
    parts["text"] = cfg["num_transformer_layers"] * (
        4 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * ffn)
    t = h * h  # image tokens
    parts["fusion.projection"] = 2 * t * c[-1] * d
    parts["fusion.cross_attention"] = cfg["num_cross_layers"] * (
        2 * 2 * L * d * d + 2 * 2 * t * d * d + 2 * 2 * L * t * d + 2 * 2 * L * d * 4 * d)
    if cfg["use_gating"]:
        parts["fusion.gate"] = 2 * 2 * d * d
    a = cfg["answer_hidden_dim"]
    parts["head"] = 2 * (d * a + a * (a // 2) + (a // 2) * cfg["num_answers"])
    parts["total"] = sum(parts.values())
    return parts
