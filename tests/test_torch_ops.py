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
from vqa_tpu.ops.cross_attention_kernel import xla_cross_attention
from vqa_tpu_torch import ops as tops
from vqa_tpu_torch.ops.se_kernel import (
    CLUSTER_FILL, MAX_SMEM, NUM_SMS, SM_SHARED, se_plan)
from vqa_tpu_torch.ops.stem_kernel import stem_output_hw, stem_takes


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


@pytest.mark.parametrize("c,r", [(64, 4), (6, 1), (12, 1)])
def test_plain_se_matches_pallas(c, r):
    """C = 6 and 12 with r = 1 are the SEs of the narrow models the JAX
    package runs (reduction 16, r = max(C // 16, 1))."""
    rng = np.random.default_rng(0)
    b, hh, ww = 2, 7, 7
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
    with pytest.raises(ValueError, match="shape"):
        tops.fused_se(x, w1, w2.t().contiguous())
    with pytest.raises(ValueError, match="shape"):
        tops.fused_se(x, w1[:, :6].contiguous(), w2)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_se(x.transpose(1, 2), w1, w2)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_se(x.double(), w1, w2)

    q, k, v, scale = _xattn_args(rng)
    with pytest.raises(ValueError, match="shape"):
        tops.fused_cross_attention(q, k[:, :1].contiguous(), v, scale)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tops.fused_cross_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, scale)


def _head_views(rng, b, h, lq, lkv, dh):
    """q, k, v as the model passes them: [B,H,L,d] views of [B,L,H,d]
    projections, plus the same values as contiguous numpy arrays."""
    arrs = [rng.standard_normal((b, n, h, dh)).astype(np.float32) for n in (lq, lkv, lkv)]
    views = [_t(a).transpose(1, 2) for a in arrs]
    return views, [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in arrs]


@pytest.mark.parametrize("b,h,lq,lkv,dh", [(2, 8, 20, 49, 32), (1, 2, 6, 70, 16),
                                           (3, 1, 1, 1, 4)])
def test_cross_attention_takes_head_transposed_views(b, h, lq, lkv, dh):
    """Strided [B,H,L,d] views of [B,L,H,d] memory go in without a copy and
    match the JAX XLA path on the same numpy inputs."""
    rng = np.random.default_rng(3)
    (q, k, v), (qn, kn, vn) = _head_views(rng, b, h, lq, lkv, dh)
    assert not q.is_contiguous() or h == 1
    scale = float(np.sqrt(dh))
    ctx_j, w_j = xla_cross_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), scale)
    ctx_t, w_t = tops.fused_cross_attention(q, k, v, scale)
    assert ctx_t.shape == (b, h, lq, dh) and w_t.shape == (b, h, lq, lkv)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_cross_attention_raises_on_non_unit_last_stride(which):
    rng = np.random.default_rng(4)
    args = dict(zip("qkv", _xattn_args(rng)[:3]))
    args[which] = _t(rng.standard_normal((*args[which].shape[:3], 16)).astype(np.float32))[..., ::2]
    assert args[which].stride(-1) == 2
    with pytest.raises(ValueError, match=f"{which} must have a contiguous last dimension"):
        tops.fused_cross_attention(args["q"], args["k"], args["v"], 8 ** 0.5)


def test_cross_attention_raises_beyond_the_kernel_limits():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 1, 2, 136)).astype(np.float32))
    kv = _t(rng.standard_normal((1, 1, 3, 136)).astype(np.float32))
    with pytest.raises(ValueError, match="d <= 128"):
        tops.fused_cross_attention(q, kv, kv, 1.0)
    q = _t(rng.standard_normal((1, 1, 2, 8)).astype(np.float32))
    kv = _t(rng.standard_normal((1, 1, 257, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="L_kv <= 256"):
        tops.fused_cross_attention(q, kv, kv, 1.0)


# (H = W, C) of the four SE stages at 224 px, full width
_SE_STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))


def _covers_once(plan, hw, c):
    """The blocks' tiles of rows x channels partition the image."""
    seen = np.zeros((hw, c), np.int64)
    for r0, r1, c0, c1 in plan.tiles(hw, c):
        seen[r0:r1, c0:c1] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("hw,c", _SE_STAGES)
def test_se_plan_is_resident_at_full_width(b, hw, c):
    """Every full-width stage holds its image in its cluster's shared
    memory (within 227 KB per block), the blocks' tiles cover the image
    once, and a split by channels gives each block 16-byte slices. The one
    exception is stage 1 at B = 32: 32 resident clusters do not fit the card
    at once (30 do), so its blocks keep two thirds of their rows, which lets
    a third block onto each SM, and stream the rest."""
    plan = se_plan(b, hw * hw, c, c // 16)
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.cluster == (8 if b == 32 else 16)
    assert _covers_once(plan, hw * hw, c)
    assert all((c1 - c0) % 4 == 0 for _, _, c0, c1 in plan.tiles(hw * hw, c))
    # stage 1 (64 channels) splits by rows; stages 3 and 4 by channels
    assert plan.rows is (c == 64 or (b == 1 and c == 128))
    if (b, c) == (32, 64):
        slots = SM_SHARED // (plan.smem_bytes + 1024)
        assert slots == 3 and CLUSTER_FILL * NUM_SMS * slots / plan.cluster >= b
        assert 0.6 * plan.block_rows(hw * hw) < plan.keep_rows < plan.block_rows(hw * hw)
    else:
        assert plan.resident(hw * hw) and plan.keep_rows == plan.block_rows(hw * hw)
        assert plan.smem_bytes >= 4 * hw * hw * c // plan.cluster


@pytest.mark.parametrize("b,hw,c,r,resident", [
    (32, 112 * 112, 64, 4, False), (1, 112 * 112, 64, 4, True), (4, 56 * 56, 64, 4, True),
    (1, 1, 1, 1, True), (3, 15, 6, 1, True), (3, 15, 12, 3, True), (1, 49, 2048, 128, True)])
def test_se_plan_streams_what_does_not_fit_and_covers_every_row(b, hw, c, r, resident):
    """Stage 1 at 448 px (112 x 112 rows of 64 channels, 3.2 MB per image)
    streams at B = 32 (8 blocks of 401 KB) and fits 16 blocks at B = 1;
    narrow widths get no more blocks than rows or channel slices; the tiles
    cover the image once."""
    plan = se_plan(b, hw, c, r)
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.resident(hw) is resident
    assert plan.keep_rows == (plan.block_rows(hw) if resident else 0)
    assert plan.cluster <= (hw if plan.rows else c)
    assert _covers_once(plan, hw, c)


@pytest.mark.parametrize("cin,cout,takes", [(3, 64, True), (3, 8, True), (3, 12, False),
                                            (3, 128, False), (1, 64, False), (3, 0, False)])
def test_stem_gate(cin, cout, takes):
    """The geometry the stem kernel takes: the backbone's gate and the
    wrapper's check."""
    assert stem_takes(cin, cout) is takes
