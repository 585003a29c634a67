"""``CBAMBlock`` and ``SelfAttention2D`` of the port against the flax modules
of ``vqa_tpu/models/attention_modules.py:97-139``, on the same numpy inputs
and weights (carried by ``compat.jax_weights.module_state_dict_from_jax``),
within 1e-5 in f32.

``SelfAttention2D``'s ``gamma`` is set to 0.5: at its initial 0 the module
is the identity and a comparison would prove nothing.
"""

import jax
import numpy as np
import pytest
import torch

from vqa_tpu.models import attention_modules as jax_modules
from vqa_tpu_torch.compat.jax_weights import module_state_dict_from_jax
from vqa_tpu_torch.models import CBAMBlock, SelfAttention2D
from vqa_tpu_torch.ops import se_kernel
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
# (B, H, W, C): a 7x7 stage output, an odd H x W
SHAPES = [(2, 7, 7, 32), (2, 5, 3, 16)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _numpy(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _port(cls, channels, variables, **kwargs):
    m = cls(channels, **kwargs).eval()
    m.load_state_dict(module_state_dict_from_jax(variables), strict=True)
    return m


@pytest.mark.parametrize("shape", SHAPES)
def test_cbam_block_matches_flax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    flax_m = jax_modules.CBAMBlock(shape[3], reduction=8)
    variables = _numpy(flax_m.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(flax_m.apply)(variables, x))
    with torch.no_grad():
        got = _port(CBAMBlock, shape[3], variables, reduction=8)(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_self_attention_2d_matches_flax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    flax_m = jax_modules.SelfAttention2D(shape[3], reduction=8)
    variables = _numpy(flax_m.init(jax.random.PRNGKey(1), x))
    assert float(variables["params"]["gamma"][0]) == 0.0
    variables["params"]["gamma"] = np.array([0.5], np.float32)
    want = np.asarray(jax.jit(flax_m.apply)(variables, x))
    with torch.no_grad():
        port = _port(SelfAttention2D, shape[3], variables, reduction=8)
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
        assert float(SelfAttention2D(shape[3]).gamma) == 0.0
    assert np.abs(want - x).max() > 0.1  # gamma 0.5 moves the output off x
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_cbam_block_eval_forward_on_the_cpu_computes_plain_se(monkeypatch):
    """On a CPU tensor the SE kernel's wrapper computes ``plain_se``: once per
    eval call, on the module's own fc1/fc2 weights."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 7, 7)).astype(
        np.float32))
    m = CBAMBlock(32, reduction=8).eval()
    calls = []
    plain = se_kernel.plain_se

    def counted(nhwc, w1, w2):
        calls.append((tuple(nhwc.shape), w1 is m.se.fc1.weight, w2 is m.se.fc2.weight))
        return plain(nhwc, w1, w2)

    monkeypatch.setattr(se_kernel, "plain_se", counted)
    with torch.no_grad():
        got = m(x)
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        want = m.spatial(plain(nhwc, m.se.fc1.weight, m.se.fc2.weight).permute(0, 3, 1, 2))
    assert calls == [((2, 7, 7, 32), True, True)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_modules_compute_in_bf16_from_their_own_copies():
    """Each module is the root of its own compute dtype: bf16 copies in eval
    mode, not read in training mode, refreshed in place on leaving it and on
    a load."""
    x = torch.randn(2, 16, 5, 3).to(torch.bfloat16)
    for m in (CBAMBlock(16, reduction=4), SelfAttention2D(16, reduction=4)):
        m.eval().set_compute_dtype(torch.bfloat16)
        conv = m.spatial.conv if isinstance(m, CBAMBlock) else m.query
        assert conv.compute_weight.dtype == torch.bfloat16
        with torch.no_grad():
            y = m(x)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape and bool(torch.isfinite(y).all())
        ptr = conv.compute_weight.data_ptr()
        m.train()
        # a training forward casts the f32 weight, differentiably
        assert conv.compute("weight") is not conv.compute_weight
        assert conv.compute("weight").requires_grad
        m.eval()
        with torch.no_grad():
            conv.weight.add_(1.0)
        m.load_state_dict(m.state_dict(), strict=True)
        torch.testing.assert_close(conv.compute_weight, conv.weight.to(torch.bfloat16))
        assert conv.compute_weight.data_ptr() == ptr
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        CBAMBlock(16).set_compute_dtype(torch.float16)


def test_module_weights_reject_an_unknown_flax_leaf():
    with pytest.raises(KeyError, match="no mapping for params:se/fc1/scale"):
        module_state_dict_from_jax({"params": {"se": {"fc1": {"scale": np.ones(3)}}}})


def test_models_package_exports_the_attention_modules():
    import vqa_tpu_torch.models as models

    for name in ("SEAttention", "SpatialAttention", "CBAMBlock", "SelfAttention2D",
                 "AttentionWrapper"):
        assert hasattr(models, name), name
