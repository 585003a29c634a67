"""The bf16 cross-attention kernel's design, held on the CPU.

The kernel (``csrc/cross_attention.cu``, ``cross_attention_bf16``) cannot
run here, so what surrounds it is checked in Python: its launch geometry
(``bf16_geometry``: slices per block, warps, threads, shared memory, the
shapes it refuses) at the shapes the model runs, and its arithmetic,
emulated in plain PyTorch, against ``plain_cross_attention`` within one
bf16 ulp per element. The card holds the kernel to the same bound
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11 (a)).
"""

import math

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops.cross_attention_kernel import (
    MAX_SMEM, bf16_geometry, fused_cross_attention, plain_cross_attention, smem_bytes)
from vqa_tpu_torch.utils.config import ModelConfig, tiny_model_config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16


def _ulps(got, want) -> float:
    """Largest |got - want| in bf16 spacings at the larger magnitude (as
    ``chip_smoke.bf16_compare`` measures it on the card)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _model_shape(cfg, heads=None):
    """(heads, L_q, L_kv, d) of the model's cross-attention; ``heads`` for a
    tensor-parallel rank's local heads."""
    h = cfg.num_attention_heads
    return (heads or h, cfg.max_question_length, cfg.feature_spatial_size ** 2,
            cfg.embed_dim // h)


# the full-width model at buckets 1, 8 and 32 (8 heads, and 4 or 1 on a
# tensor-parallel rank), and the tiny config's
@pytest.mark.parametrize("cfg,b,heads,want", [
    (ModelConfig(), 32, None, (10, 320, 15856, 256)),
    (ModelConfig(), 8, None, (10, 320, 15856, 64)),
    (ModelConfig(), 1, None, (10, 320, 15856, 8)),
    (ModelConfig(), 32, 4, (10, 320, 15856, 128)),
    (ModelConfig(), 1, 1, (10, 320, 15856, 1)),
    (tiny_model_config(), 3, None, (4, 128, 1088, 6)),
], ids=["full-b32", "full-b8", "full-b1", "full-b32-h4", "full-b1-h1", "tiny-b3"])
def test_bf16_geometry_at_the_model_shapes(cfg, b, heads, want):
    """One (batch, head) slice per block of ceil(L_q/2) warps; the shared
    memory of the layout in ``csrc/cross_attention.cu`` (q, k and v in
    bf16, and each warp's f32 probabilities and staged output rows)."""
    h, lq, lkv, d = _model_shape(cfg, heads)
    g = bf16_geometry(b * h, lq, lkv, d)
    assert tuple(g) == want
    assert g.threads == 32 * g.warps <= 512
    assert g.warps * 2 >= min(lq, 32)


def test_bf16_geometry_refuses_what_the_kernel_refuses():
    """d <= 128 and L_kv <= 256 within 227 KB; more query rows than 16
    warps hold at once loop. The wrapper refuses the same shapes on the CPU
    path. Every shape the f32 form's layout takes (the old bf16 form's),
    the bf16 layout takes too."""
    assert bf16_geometry(4, 20, 256, 128).smem_bytes <= MAX_SMEM
    assert bf16_geometry(2, 400, 64, 32).warps == 16
    for shape in ((4, 20, 49, 129), (4, 20, 257, 32), (4, 9000, 49, 32), (0, 20, 49, 32)):
        with pytest.raises(ValueError):
            bf16_geometry(*shape)
    q = torch.zeros(1, 1, 20, 129, dtype=BF16)
    with pytest.raises(ValueError, match="d <= 128"):
        fused_cross_attention(q, q, q, 1.0)
    k = torch.zeros(1, 1, 257, 32, dtype=BF16)
    with pytest.raises(ValueError, match="L_kv <= 256"):
        fused_cross_attention(torch.zeros(1, 1, 20, 32, dtype=BF16), k, k, 1.0)
    for lq in (1, 6, 20, 33, 200, 1000):
        for lkv in range(1, 257, 5):
            for d in range(1, 129, 3):
                if smem_bytes(lq, lkv, d) <= MAX_SMEM:
                    bf16_geometry(1, lq, lkv, d)


def _emulate(q, k, v, scale):
    """The bf16 kernel's arithmetic in plain PyTorch ops: q, k, v read as
    bf16; each score a sequential chain over d from 0 (a product of two
    bf16 values is exact in f32, so each step is one f32 rounding, as
    ``fmaf``); the scaled softmax in f32 (taken with the plain version's
    own ops, whose f32 rounding on each device is that device's: on the
    card, PyTorch scales a CUDA tensor by a Python float as a product with
    its f32 reciprocal, which is what the kernel computes); P kept in f32;
    each context element a sequential chain over the keys from 0, each step
    an ``fmaf`` (the product formed exactly in f64, then one rounding to
    f32); both outputs rounded once to bf16."""
    q, k, v = q.float(), k.float(), v.float()
    s = torch.zeros(q.shape[:-1] + (k.shape[-2],))
    for i in range(q.shape[-1]):
        s = s + q[..., :, i:i + 1] * k[..., None, :, i]
    p = torch.softmax(s / scale, dim=-1)
    ctx = torch.zeros(q.shape, dtype=torch.float64)
    p64, v64 = p.double(), v.double()
    for j in range(k.shape[-2]):
        ctx = (ctx + p64[..., j:j + 1] * v64[..., None, j, :]).float().double()
    return ctx.float().to(BF16), p.to(BF16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_cross_attention_arithmetic_within_one_ulp(seed):
    """At the main path's shape (bucket 32, 8 heads, L_q 20, L_kv 49, d
    32), the emulated kernel is within one bf16 ulp of
    ``plain_cross_attention`` in every element of both outputs: the kernel
    keeps the plain version's order of the sums (any other order of the
    d-sums, such as a tensor-core product's, moves a few context elements
    near 0 beyond one ulp) and keeps P in f32."""
    rng = np.random.default_rng(seed)
    b, h, lq, lkv, d = 32, 8, 20, 49, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32)).to(BF16)
               for n in (lq, lkv, lkv))
    ctx, w = _emulate(q, k, v, math.sqrt(d))
    pctx, pw = plain_cross_attention(q, k, v, math.sqrt(d))
    assert ctx.dtype == w.dtype == BF16
    assert _ulps(ctx, pctx) <= 1 and _ulps(w, pw) <= 1
