"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an NVIDIA GPU and no JAX, run them without the
suite's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes cover the full-width path and the odd geometries the kernels
accept (tiny widths, odd image sizes, C/r = 1). Tolerances are those of
the Pallas kernels' tests: stem 1e-5, SE 1e-3, cross-attention 1e-5 on
the context and 1e-6 on the weights.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,h,w,cout", [(2, 224, 224, 64), (3, 64, 64, 8),
                                        (1, 37, 50, 16), (2, 17, 9, 24), (1, 1, 1, 8)])
def test_stem_kernel_matches_plain(cuda, b, h, w, cout):
    rng = np.random.default_rng(0)
    x = _randn(rng, (b, h, w, 3), cuda)
    wt = _randn(rng, (cout, 3, 7, 7), cuda, 0.05)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(cuda)
    bias = _randn(rng, (cout,), cuda, 0.1)
    before = ops.fused_stem.launches
    got = ops.fused_stem(x, wt, scale, bias)
    torch.cuda.synchronize()
    assert ops.fused_stem.launches == before + 1
    torch.testing.assert_close(got, ops.plain_stem(x, wt, scale, bias),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,w,c,r", [(2, 56, 56, 64, 4), (2, 7, 7, 512, 32),
                                       (3, 8, 8, 8, 1), (2, 5, 3, 12, 3)])
def test_se_kernel_matches_plain(cuda, b, h, w, c, r):
    rng = np.random.default_rng(1)
    x = torch.relu(_randn(rng, (b, h, w, c), cuda))
    w1, w2 = _randn(rng, (r, c), cuda, 0.2), _randn(rng, (c, r), cuda, 0.2)
    before = ops.fused_se.launches
    got = ops.fused_se(x, w1, w2)
    torch.cuda.synchronize()
    assert ops.fused_se.launches == before + 1
    torch.testing.assert_close(got, ops.plain_se(x, w1, w2), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("b,h,lq,lkv,d", [(2, 8, 20, 49, 32), (1, 2, 5, 7, 8),
                                          (3, 1, 1, 1, 4), (1, 2, 6, 70, 16)])
def test_cross_attention_kernel_matches_plain(cuda, b, h, lq, lkv, d):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (b, h, n, d), cuda) for n in (lq, lkv, lkv))
    before = ops.fused_cross_attention.launches
    ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(d))
    torch.cuda.synchronize()
    assert ops.fused_cross_attention.launches == before + 1
    pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(d))
    torch.testing.assert_close(ctx, pctx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(w, pw, atol=1e-6, rtol=1e-5)


def test_se_kernel_raises_on_misaligned_input(cuda):
    x = torch.zeros(2 * 4 * 4 * 8 + 1, device=cuda)[1:].view(2, 4, 4, 8)
    with pytest.raises(ValueError, match="aligned"):
        ops.fused_se(x, torch.zeros(2, 8, device=cuda), torch.zeros(8, 2, device=cuda))


def test_tiny_model_kernels_match_plain_and_cpu(cuda):
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    cpu_model = create_vqa_model(config=cfg, device="cpu", seed=5)
    model = create_vqa_model(config=cfg, device=cuda, seed=5)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size, (4, cfg.max_question_length))
    mask = np.ones_like(ids, dtype=np.int32)
    mask[0, 3:] = 0
    args = [torch.from_numpy(a) for a in (images, ids, mask)]
    counts = ops.launch_counts()
    got = forward_logits(model, *(a.to(cuda) for a in args))
    assert {k: ops.launch_counts()[k] - counts[k] for k in counts} == {
        "stem": 1, "se": 4, "cross_attention": 2}
    with mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
            mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
            mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                              cross_attention_kernel.plain_cross_attention):
        plain = forward_logits(model, *(a.to(cuda) for a in args))
    torch.testing.assert_close(got, plain, atol=1e-3, rtol=0)
    torch.testing.assert_close(got.cpu(), forward_logits(cpu_model, *args),
                               atol=1e-3, rtol=0)
