"""The port's bf16 inference against the JAX package's, on the CPU.

- Each kernel's plain bf16 version against the Pallas function in bf16
  (interpret mode, as tests/test_ops.py runs the kernels): both compute in
  f32 and round once, so they are held to one bf16 ulp per element,
  compared as f32 (the spacing of bf16 at the larger magnitude of the
  two), and the output dtype is bf16.
- The tiny model and the CPU engine in bf16 against JAX's with the same
  weights. The bound calibrates itself. Model logits: the port's bf16
  logits may be no further from JAX's bf16 logits than twice JAX's own
  bf16 noise (its bf16 logits against its f32 ones on the same inputs),
  and the argmax agrees with JAX's on every row whose top-2 margin exceeds
  that bound. Engine probabilities: the two bf16 computations round at
  other places, so their errors are independent and of one size, and on
  probabilities, where a logit error common to a row cancels in JAX's own
  noise, their distance can exceed twice that noise (it did on 5
  requests). So the engine is held to what the rule is after: the port's
  own bf16 noise (bf16 against its f32 engine) within 2x JAX's, the
  distance between the two bf16 engines within the sum of their own
  noises, and the argmax to JAX's bf16 one on every row whose margin
  exceeds that sum.
- The policy's contract: a bf16 model's state_dict is the f32 one (keys,
  dtypes, values) and its checkpoint loads unchanged; its bf16 weight
  copies are the f32 weights rounded; weights loaded later refresh them;
  training mode drops them and keeps f32 parameters; the wrappers raise
  on f16 and f64 and on mixed dtypes; the engine computes in f32 on the
  CPU unless asked for bf16; the SE plan for 2-byte elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.models import create_vqa_model as jax_create_vqa_model
from vqa_tpu.models import forward_logits as jax_forward_logits
from vqa_tpu.models import init_vqa_model
from vqa_tpu.ops import fused_cross_attention, fused_se
from vqa_tpu.ops.stem_kernel import fused_stem as jax_fused_stem
from vqa_tpu.serving.engine import VQAInference as JaxInference
from vqa_tpu.utils.config import InferenceConfig as JaxInferenceConfig
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch import ops
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.ops.se_kernel import MAX_SMEM, se_plan
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.utils.config import InferenceConfig, model_config_from_dict

BF16 = torch.bfloat16
TINY = dict(vocab_size=50, embed_dim=32, num_answers=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=64, max_question_length=8,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """A numpy f32 array rounded to bf16, as (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(BF16)


def ulps(got, want) -> float:
    """Largest |got - want| over elements, in bf16 spacings at the larger
    magnitude of the two."""
    g = torch.as_tensor(np.asarray(got, np.float32)) if not isinstance(got, torch.Tensor) \
        else got.float()
    w = torch.as_tensor(np.asarray(want, np.float32)) if not isinstance(want, torch.Tensor) \
        else want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / spacing).max())


def test_plain_cross_attention_bf16_matches_pallas():
    rng = np.random.default_rng(0)
    b, h, lq, lkv, dh = 2, 2, 20, 49, 32
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng.standard_normal((b, h, n, dh)))
                                    for n in (lq, lkv, lkv))
    scale = float(np.sqrt(dh))
    ctx_j, w_j = fused_cross_attention(qj, kj, vj, scale, interpret=True)
    ctx_t, w_t = ops.plain_cross_attention(qt, kt, vt, scale)
    assert ctx_j.dtype == jnp.bfloat16 and ctx_t.dtype == w_t.dtype == BF16
    assert ulps(ctx_t, ctx_j.astype(jnp.float32)) <= 1
    assert ulps(w_t, w_j.astype(jnp.float32)) <= 1
    # the wrapper on CPU tensors is the plain version, counted nowhere
    ops.reset_launch_counts()
    for got, want in zip(ops.fused_cross_attention(qt, kt, vt, scale), (ctx_t, w_t)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("c,r", [(64, 4), (6, 1), (12, 1)])
def test_plain_se_bf16_matches_pallas(c, r):
    rng = np.random.default_rng(1)
    xj, xt = _bf16(rng.standard_normal((2, 7, 7, c)))
    w1j, w1t = _bf16(rng.standard_normal((c, c // r)) * 0.1)  # flax [in, out]
    w2j, w2t = _bf16(rng.standard_normal((c // r, c)) * 0.1)
    y_j = fused_se(xj, w1j, w2j, interpret=True)
    # the port takes the nn.Linear layouts [out, in]
    y_t = ops.plain_se(xt, w1t.t().contiguous(), w2t.t().contiguous())
    assert y_j.dtype == jnp.bfloat16 and y_t.dtype == BF16
    assert ulps(y_t, y_j.astype(jnp.float32)) <= 1
    torch.testing.assert_close(ops.fused_se_bf16(xt, w1t.t().contiguous(), w2t.t().contiguous()),
                               y_t, rtol=0, atol=0)


def test_plain_stem_bf16_matches_pallas():
    """The Pallas stem takes the full 224 px geometry only (B = 1 here)."""
    rng = np.random.default_rng(2)
    xj, xt = _bf16(rng.standard_normal((1, 224, 224, 3)))
    w = (rng.standard_normal((7, 7, 3, 64)) * 0.05).astype(np.float32)  # HWIO
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    out_j = jax_fused_stem(xj, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                           interpret=True)
    wt = _t(w.transpose(3, 2, 0, 1)).to(BF16)  # OIHW, cast as the Pallas wrapper casts
    out_t = ops.plain_stem(xt, wt, _t(scale), _t(bias))
    assert out_j.dtype == jnp.bfloat16 and out_t.dtype == BF16
    assert out_t.shape == out_j.shape == (1, 56, 56, 64)
    assert ulps(out_t, out_j.astype(jnp.float32)) <= 1
    torch.testing.assert_close(ops.fused_stem_bf16(xt, wt, _t(scale), _t(bias)), out_t,
                               rtol=0, atol=0)


def _self_calibrated(port16, jax16, jax32):
    """The bound of the module docstring; returns (error, bound)."""
    jax16, jax32 = np.asarray(jax16, np.float32), np.asarray(jax32, np.float32)
    port16 = np.asarray(port16, np.float32)
    noise = float(np.abs(jax16 - jax32).max())
    assert noise > 0, "the JAX side did not compute in bf16"
    bound = 2 * noise
    err = float(np.abs(port16 - jax16).max())
    assert err <= bound, f"port bf16 vs JAX bf16 {err:.3e} > 2 x JAX's own bf16 noise {noise:.3e}"
    s = -np.sort(-jax16, axis=-1)
    clear = s[:, 0] - s[:, 1] > bound
    assert (port16.argmax(-1) == jax16.argmax(-1))[clear].all()
    return err, bound


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxModelConfig(**TINY)
    variables = init_vqa_model(jax_create_vqa_model(config=jcfg), jax.random.PRNGKey(0))
    cfg = model_config_from_dict(model_config_dict(jcfg))
    return jcfg, variables, cfg, state_dict_from_jax(variables, cfg)


def test_tiny_model_bf16_matches_jax_bf16(tiny):
    jcfg, variables, cfg, state = tiny
    rng = np.random.default_rng(3)
    b, L = 6, TINY["max_question_length"]
    images = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(4, TINY["vocab_size"], (b, L)).astype(np.int32)
    mask = (np.arange(L)[None] < rng.integers(2, L + 1, (b, 1))).astype(np.int32)
    args = [jnp.asarray(a) for a in (images, ids, mask)]
    j32 = jax_forward_logits(jax_create_vqa_model(config=jcfg), variables, *args)
    j16 = jax_forward_logits(jax_create_vqa_model(config=jcfg, dtype=jnp.bfloat16),
                             variables, *args)
    model = create_vqa_model(config=cfg, device="cpu", dtype=BF16)
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        p16, _ = model(_t(images), _t(ids).long(), _t(mask))
    assert p16.dtype == torch.float32 and j16.dtype == jnp.float32
    _self_calibrated(p16.numpy(), j16, j32)


def test_engine_bf16_matches_jax_engine_bf16(tiny):
    jcfg, variables, cfg, state = tiny
    buckets = dict(batch_buckets=(4,))  # one compiled forward per JAX engine
    jax16 = JaxInference(model_config=jcfg, config=JaxInferenceConfig(**buckets),
                         dtype=jnp.bfloat16).load()
    jax32 = JaxInference(model_config=jcfg, config=JaxInferenceConfig(**buckets),
                         dtype=jnp.float32).load()
    jax16.variables = jax32.variables = variables
    engine = VQAInference(model_config=cfg, config=InferenceConfig(**buckets), device="cpu",
                          dtype=BF16).load()
    engine.model.load_state_dict(state, strict=True)
    assert engine.model.dtype == BF16
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
              for h, w in rng.integers(30, 90, (5, 2))]
    questions = ["what color is the cat", "how many dogs are there", "is this a man",
                 "what is the woman wearing", "what"]
    got = engine.predict_batch_raw(images, questions)
    assert got.dtype == np.float32 and np.allclose(got.sum(-1), 1, atol=1e-5)
    engine32 = VQAInference(model_config=cfg, config=InferenceConfig(**buckets), device="cpu",
                            dtype=torch.float32).load()
    engine32.model.load_state_dict(state, strict=True)
    p32 = engine32.predict_batch_raw(images, questions)
    j16, j32 = (e.predict_batch_raw(images, questions) for e in (jax16, jax32))
    assert np.abs(p32 - j32).max() <= 1e-5  # the f32 engines agree
    noise_j, noise_p = float(np.abs(j16 - j32).max()), float(np.abs(got - p32).max())
    assert 0 < noise_p <= 2 * noise_j, (noise_p, noise_j)
    bound = noise_j + noise_p
    assert float(np.abs(got - j16).max()) <= bound + 1e-5
    s = -np.sort(-j16, axis=-1)
    clear = s[:, 0] - s[:, 1] > bound
    assert (got.argmax(-1) == j16.argmax(-1))[clear].all()
    att = engine.attention_map(images[0], questions[0])
    maps = np.asarray(att["attention"]["maps"])
    assert maps.dtype == np.float64 and np.allclose(maps.sum((1, 2)), 1, atol=1e-2)


def test_bf16_model_keeps_the_f32_state_dict_and_checkpoint(tmp_path):
    from vqa_tpu_torch.training import checkpoint as ckpt_lib
    from vqa_tpu_torch.utils.config import tiny_model_config

    cfg = tiny_model_config()
    m32 = create_vqa_model(config=cfg, device="cpu", seed=7)
    m16 = create_vqa_model(config=cfg, device="cpu", seed=7, dtype=BF16)
    s32, s16 = m32.state_dict(), m16.state_dict()
    assert list(s16) == list(s32)
    for k, v in s32.items():
        assert s16[k].dtype == v.dtype and torch.equal(s16[k], v), k
    # one bf16 copy of each weight, rounded from the f32 one; none in f32
    fc1 = m16.text_encoder.layers[0].ffn.fc1
    assert fc1.compute_weight.dtype == BF16
    assert torch.equal(fc1.compute_weight, fc1.weight.to(BF16))
    assert torch.equal(m16.text_encoder.positional_encoding.compute_pe,
                       m16.text_encoder.positional_encoding.pe.to(BF16))
    assert m32.text_encoder.layers[0].ffn.fc1.compute_weight is None
    assert not any(n.startswith("compute_") or ".compute_" in n for n, _ in m32.named_buffers())

    ckpt_lib.save_checkpoint(str(tmp_path), "latest", {"model_state_dict": s32},
                             model_config=cfg, meta={})
    loaded = ckpt_lib.load_model_for_inference(str(tmp_path), "latest", device="cpu",
                                               dtype=BF16)
    assert loaded.dtype == BF16 and not loaded.training
    for k, v in loaded.state_dict().items():
        assert v.dtype == s32[k].dtype and torch.equal(v, s32[k]), k
    # weights loaded later refresh the copies
    other = create_vqa_model(config=cfg, device="cpu", seed=8)
    loaded.load_state_dict(other.state_dict())
    fc1 = loaded.text_encoder.layers[0].ffn.fc1
    assert torch.equal(fc1.compute_weight, other.text_encoder.layers[0].ffn.fc1.weight.to(BF16))
    # training mode works and keeps the f32 parameters; it does not read the
    # bf16 copies, which leaving it refreshes in place
    ptr = fc1.compute_weight.data_ptr()
    loaded.train()
    assert loaded.training and loaded.dtype == BF16
    assert all(p.dtype == torch.float32 for p in loaded.parameters())
    assert fc1.compute("weight") is not fc1.compute_weight
    loaded.eval()
    assert torch.equal(loaded.text_encoder.layers[0].ffn.fc1.compute_weight,
                       other.text_encoder.layers[0].ffn.fc1.weight.to(BF16))
    assert fc1.compute_weight.data_ptr() == ptr
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        m32.set_compute_dtype(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_raise_on_other_dtypes(dtype):
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((1, 16, 16, 3)).astype(np.float32))
    w = _t(rng.standard_normal((8, 3, 7, 7)).astype(np.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_stem(x.to(dtype), w.to(dtype), torch.ones(8), torch.zeros(8))
    xs = _t(rng.standard_normal((1, 4, 4, 16)).astype(np.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_se(xs.to(dtype), torch.ones(4, 16, dtype=dtype), torch.ones(16, 4, dtype=dtype))
    q = _t(rng.standard_normal((1, 2, 3, 8)).astype(np.float32)).to(dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_cross_attention(q, q, q, 8 ** 0.5)
    # and on mixed dtypes: a form takes one dtype throughout
    with pytest.raises(TypeError, match="bfloat16"):
        ops.fused_stem(x.to(BF16), w, torch.ones(8), torch.zeros(8))
    with pytest.raises(TypeError, match="float32"):
        ops.fused_stem(x, w, torch.ones(8, dtype=BF16), torch.zeros(8))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.fused_se(xs.to(BF16), torch.ones(4, 16), torch.ones(16, 4))
    with pytest.raises(TypeError, match="bfloat16"):
        ops.fused_cross_attention(q.to(BF16), q.float(), q.to(BF16), 8 ** 0.5)
    with pytest.raises(TypeError, match="takes bfloat16"):
        ops.fused_se_bf16(xs, torch.ones(4, 16), torch.ones(16, 4))


def test_engine_dtype_policy_on_the_cpu():
    from vqa_tpu_torch.utils.config import tiny_model_config

    default = VQAInference(model_config=tiny_model_config(), device="cpu")
    assert default.dtype == torch.float32
    assert default.load().model.dtype == torch.float32
    forced = VQAInference(model_config=tiny_model_config(), device="cpu", dtype=BF16).load()
    assert forced.model.dtype == BF16 and forced.dtype == BF16
    probs = forced.predict_batch_raw([np.zeros((20, 30, 3), np.uint8)], ["what is this"])
    assert probs.dtype == np.float32 and abs(float(probs.sum()) - 1) < 1e-5


def _bf16_plan_holds(plan, b, hw, c):
    """Within 227 KB, a legal cluster (up to 16 blocks, the most the
    kernel launches, and no more blocks than rows or channels), channel
    slices of whole 16-byte vectors where C has them, and the tiles cover
    the image once."""
    assert plan.smem_bytes <= MAX_SMEM
    assert 1 <= plan.cluster <= 16 and plan.cluster <= (hw if plan.rows else c)
    assert 0 <= plan.keep_rows <= plan.block_rows(hw)
    seen = np.zeros((hw, c), np.int64)
    for r0, r1, c0, c1 in plan.tiles(hw, c, 2):
        seen[r0:r1, c0:c1] += 1
        assert plan.rows or c % 8 or (c1 - c0) % 8 == 0
    assert (seen == 1).all()


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("hw,c", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_se_plan_for_bf16_holds_every_stage(b, hw, c):
    """In bf16 a block holds twice the rows: every full-width stage is
    resident (stage 1 at B = 32 too, which in f32 keeps two thirds of its
    rows), within 227 KB, with channel slices of whole 16-byte vectors (8
    bf16), and the tiles cover the image once; the cluster sizes are the
    f32 form's (8 from 17 images up, else 16), stage 1 split by rows at
    B = 32 and every stage with 16-channel slices or wider by channels."""
    plan = se_plan(b, hw * hw, c, c // 16, 2)
    _bf16_plan_holds(plan, b, hw * hw, c)
    assert plan.resident(hw * hw) and plan.keep_rows == plan.block_rows(hw * hw)
    assert plan.smem_bytes >= 2 * hw * hw * c // plan.cluster
    assert plan.smem_bytes < se_plan(b, hw * hw, c, c // 16).smem_bytes
    assert plan.cluster == se_plan(b, hw * hw, c, c // 16).cluster == (8 if b == 32 else 16)
    assert plan.rows is (c // plan.cluster < 16)


# the narrow widths of test_torch_models.py::test_narrow_widths_match_jax
# (tiny stages of 8-64 channels at 64 px, a first stage of 12, a last of 6)
# and CBAMBlock's channel counts (the module tests' and chip_smoke's)
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("hw,c,r", [
    (16 * 16, 8, 1), (8 * 8, 16, 1), (4 * 4, 32, 2), (2 * 2, 64, 4), (16 * 16, 12, 1),
    (2 * 2, 6, 1), (7 * 7, 32, 4), (5 * 3, 16, 2), (7 * 7, 512, 32), (56 * 56, 64, 4)])
def test_se_plan_for_bf16_at_narrow_and_cbam_widths(b, hw, c, r):
    plan = se_plan(b, hw, c, r, 2)
    _bf16_plan_holds(plan, b, hw, c)
    assert plan.resident(hw)


@pytest.mark.parametrize("b,hw,c,r", [(32, 112 * 112, 64, 4), (3, 15, 6, 1), (3, 15, 12, 3),
                                      (1, 49, 2048, 128)])
def test_se_plan_for_bf16_at_other_widths(b, hw, c, r):
    """448 px stage 1, narrow and wide channel counts: within 227 KB, tiles
    cover the image once, no more blocks than rows or channel slices."""
    plan = se_plan(b, hw, c, r, 2)
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.cluster <= (hw if plan.rows else c)
    seen = np.zeros((hw, c), np.int64)
    for r0, r1, c0, c1 in plan.tiles(hw, c, 2):
        seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="esize"):
        se_plan(b, hw, c, r, 8)
