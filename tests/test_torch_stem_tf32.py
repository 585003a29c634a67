"""The stem kernel's arithmetic on the CPU: 3xTF32 keeps the f32 contract.

``csrc/stem.cu`` computes the 7x7/2 conv as an implicit GEMM on the tensor
cores: K = 147 taps zero-padded to 152, each operand split as
hi = tf32(x), lo = tf32(x - hi) (``cvt.rna.tf32.f32``), and per k-step of 8
the f32 accumulator takes lo*hi, then hi*lo, then hi*hi. These tests
emulate exactly that in numpy (TF32 products are exact in f32, so only the
order of the f32 sums can differ from the card), then the BN affine, ReLU,
the zero-padded 3x3/2 pool, and hold the result against ``plain_stem``
within the stem's tolerance, atol/rtol 1e-5 (tests/test_ops.py:85-98). A
single TF32 product, the card's default for f32 convolutions, does not
meet it. Every conv position goes through the same arithmetic whichever
tile computes it, so the emulation works on the whole image.
"""

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops import plain_stem
from vqa_tpu_torch.ops.stem_kernel import stem_output_hw

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
K_PAD = 152  # 147 taps padded to 19 k-steps of 8


def tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    hi = tf32(a)
    return hi, tf32(a - hi)


def im2col(x: np.ndarray) -> np.ndarray:
    """[B,H,W,3] -> [B*CH*CW, 152], tap = ci*49 + kh*7 + kw, zero-padded."""
    b, h, w, _ = x.shape
    ch, cw = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)))
    cols = [xp[:, kh:kh + 2 * ch - 1:2, kw:kw + 2 * cw - 1:2, ci]
            for ci in range(3) for kh in range(7) for kw in range(7)]
    a = np.stack(cols, axis=-1).reshape(b * ch * cw, 147)
    return np.pad(a, ((0, 0), (0, K_PAD - 147))), (b, ch, cw)


def emulated_stem(x, w, scale, bias, passes=3):
    """The kernel's GEMM, epilogue and pool in numpy f32. ``passes=1``
    keeps only hi*hi: a single TF32 product."""
    a, (b, ch, cw) = im2col(x)
    wm = np.pad(w.reshape(w.shape[0], 147).T, ((0, K_PAD - 147), (0, 0)))  # [152, cout]
    (a_hi, a_lo), (w_hi, w_lo) = split(a), split(wm)
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
    for k in range(0, K_PAD, 8):
        s = slice(k, k + 8)
        terms = [(a_hi, w_hi)] if passes == 1 else [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)]
        for lhs, rhs in terms:
            acc += lhs[:, s] @ rhs[s]
    y = np.maximum(acc * scale + bias, np.float32(0)).reshape(b, ch, cw, -1)
    # pool padding holds 0, exact after ReLU (see csrc/stem.cu)
    ph, pw = (ch - 1) // 2 + 1, (cw - 1) // 2 + 1
    yp = np.pad(y, ((0, 0), (1, 2 * ph - ch), (1, 2 * pw - cw), (0, 0)))
    return np.max([yp[:, dy:dy + 2 * ph - 1:2, dx:dx + 2 * pw - 1:2]
                   for dy in range(3) for dx in range(3)], axis=0)


def _inputs(b, h, w, cout, seed=0):
    """ImageNet-normalised pixels, kaiming-normal weights (fan in 147), BN
    scale and bias as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32) / 255.0
    x = ((pixels - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    wt = (rng.standard_normal((cout, 3, 7, 7)) * np.sqrt(2.0 / 147)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, scale, bias


def _plain(x, wt, scale, bias):
    return plain_stem(*(torch.from_numpy(a) for a in (x, wt, scale, bias))).numpy()


def test_tf32_rounding_matches_cvt_rna():
    x = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                  1 + 2 ** -12, 3.0e-39, 0.0], np.float32)
    want = np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, 0.0, 0.0],
                    np.float32)
    got = tf32(x)
    np.testing.assert_array_equal(got[:5], want[:5])  # ties go away from zero
    assert got[6] == 0.0 and abs(float(got[5])) < 4e-39
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    hi, lo = split(np.float32([np.pi]))
    assert abs(float(hi[0]) + float(lo[0]) - np.pi) < 2 ** -21


def test_3xtf32_meets_the_f32_tolerance_at_the_real_geometry():
    x, wt, scale, bias = _inputs(2, 224, 224, 64)
    ref = _plain(x, wt, scale, bias)
    got = emulated_stem(x, wt, scale, bias)
    assert got.shape == ref.shape == (2, 56, 56, 64)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # one TF32 product does not
    single = emulated_stem(x, wt, scale, bias, passes=1)
    assert not np.allclose(single, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(single - ref).max() > 10 * np.abs(got - ref).max()


@pytest.mark.parametrize("b,h,w,cout", [(3, 64, 64, 8), (1, 37, 50, 16), (2, 17, 9, 24),
                                        (1, 1, 1, 8)])
def test_3xtf32_meets_the_f32_tolerance_at_odd_geometries(b, h, w, cout):
    x, wt, scale, bias = _inputs(b, h, w, cout, seed=1)
    ref = _plain(x, wt, scale, bias)
    got = emulated_stem(x, wt, scale, bias)
    assert got.shape == ref.shape == (b, *stem_output_hw(h, w), cout)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
