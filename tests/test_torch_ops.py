"""The port's kernel modules on the CPU: each plain version against the
JAX package's function on the same numpy inputs, and the wrappers' CPU
dispatch and input checks.

The Pallas kernels run in interpret mode, as tests/test_ops.py runs them;
the stem is held against its XLA oracle (the interpret-mode stem is a
slow test). Tolerances are the ones tests/test_ops.py holds the Pallas
kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.ops import fused_cross_attention, fused_se, xla_stem
from vqa_tpu_torch import ops as tops
from vqa_tpu_torch.ops.stem_kernel import stem_output_hw


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_plain_cross_attention_matches_pallas():
    rng = np.random.default_rng(0)
    b, h, lq, lkv, dh = 1, 2, 20, 49, 32
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, lkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, lkv, dh)).astype(np.float32)
    scale = float(np.sqrt(dh))
    ctx_j, w_j = fused_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, interpret=True)
    ctx_t, w_t = tops.plain_cross_attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, atol=1e-5)


def test_plain_se_matches_pallas():
    rng = np.random.default_rng(0)
    b, hh, ww, c, r = 2, 7, 7, 64, 4
    x = rng.standard_normal((b, hh, ww, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, c // r)) * 0.1).astype(np.float32)  # flax [in,out]
    w2 = (rng.standard_normal((c // r, c)) * 0.1).astype(np.float32)
    y_j = fused_se(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), interpret=True)
    # the port takes the nn.Linear layouts [out, in]
    y_t = tops.plain_se(_t(x), _t(w1.T), _t(w2.T))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("h,w,cout", [(224, 224, 64), (64, 64, 8), (37, 50, 16)])
def test_plain_stem_matches_xla_oracle(h, w, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    k = (rng.standard_normal((7, 7, 3, cout)) * 0.05).astype(np.float32)  # HWIO
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ref = np.asarray(xla_stem(jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale),
                              jnp.asarray(bias)))
    out = tops.plain_stem(_t(x), _t(k.transpose(3, 2, 0, 1)), _t(scale), _t(bias))
    assert out.shape == (1, *stem_output_hw(h, w), cout) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _stem_args(rng, b=1, h=32, w=32, cout=8):
    return (_t(rng.standard_normal((b, h, w, 3)).astype(np.float32)),
            _t(rng.standard_normal((cout, 3, 7, 7)).astype(np.float32)),
            torch.ones(cout), torch.zeros(cout))


def _se_args(rng, c=16, r=4):
    return (_t(rng.standard_normal((2, 5, 5, c)).astype(np.float32)),
            _t(rng.standard_normal((c // r, c)).astype(np.float32)),
            _t(rng.standard_normal((c, c // r)).astype(np.float32)))


def _xattn_args(rng):
    q = _t(rng.standard_normal((2, 2, 5, 8)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 2, 7, 8)).astype(np.float32))
    return q, kv, kv.clone(), 8 ** 0.5


@pytest.mark.parametrize("name", ["stem", "se", "cross_attention"])
def test_wrapper_on_cpu_is_plain_and_not_counted(name):
    """A CPU tensor takes the plain version; only kernel launches count."""
    rng = np.random.default_rng(1)
    wrapper, plain, args = {
        "stem": (tops.fused_stem, tops.plain_stem, _stem_args(rng)),
        "se": (tops.fused_se, tops.plain_se, _se_args(rng)),
        "cross_attention": (tops.fused_cross_attention, tops.plain_cross_attention,
                            _xattn_args(rng)),
    }[name]
    tops.reset_launch_counts()
    got, want = wrapper(*args), plain(*args)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tops.launch_counts() == {"stem": 0, "se": 0, "cross_attention": 0}


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    rng = np.random.default_rng(2)
    x, w, s, b = _stem_args(rng)
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.fused_stem(x, torch.zeros(12, 3, 7, 7), torch.ones(12), torch.zeros(12))
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.fused_stem(x, torch.zeros(128, 3, 7, 7), torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="NHWC"):
        tops.fused_stem(x[..., :2].contiguous(), w, s, b)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_stem(x.double(), w, s, b)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_stem(x.transpose(1, 2), w, s, b)

    x, w1, w2 = _se_args(rng)
    with pytest.raises(ValueError, match="multiple of 4"):
        tops.fused_se(x[..., :6].contiguous(), w1[:, :6].contiguous(), w2[:6].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tops.fused_se(x, w1, w2.t().contiguous())

    q, k, v, scale = _xattn_args(rng)
    with pytest.raises(ValueError, match="shape"):
        tops.fused_cross_attention(q, k[:, :1].contiguous(), v, scale)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_cross_attention(q.transpose(1, 2), k, v, scale)
