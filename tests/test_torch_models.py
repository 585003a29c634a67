"""The port's modules against the JAX package's, on the tiny config.

The JAX model is initialised and its variables carried into the port with
``state_dict_from_jax`` (strict load); both then see the same numpy
inputs. JAX runs on the CPU at 'highest' matmul precision (conftest); the
port runs on ``device="cpu"``, where every kernel wrapper computes its
plain version. Component tolerances are 1e-4: f32 sums taken in another
order through a few layers; the logits are held to the 1e-3 fidelity
target of the port.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import init_vqa_model
from vqa_tpu.models.fusion import attention_visualization as jax_attn_vis
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model, forward_logits, get_attention_maps
from vqa_tpu_torch.models.fusion import attention_visualization
from vqa_tpu_torch.utils.config import model_config_from_dict

TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2)


def _inputs(cfg, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, cfg.image_size, cfg.image_size, cfg.in_channels)).astype(np.float32)
    lengths = rng.integers(2, cfg.max_question_length + 1, batch)
    mask = (np.arange(cfg.max_question_length)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(1, cfg.vocab_size, mask.shape) * mask).astype(np.int32)
    return images, ids, mask


@functools.lru_cache(maxsize=None)
def _pair(use_attention=True, overrides=()):
    """(jax model, jax variables, port model with the same weights);
    ``overrides`` are (field, value) pairs replacing TINY's."""
    jmodel = jax_create(**{**TINY, **dict(overrides)}, use_attention=use_attention)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(0))
    cfg = model_config_from_dict(model_config_dict(jmodel.config))
    tmodel = create_vqa_model(config=cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def traced():
    """One JAX forward with aux outputs and the port's on the same inputs."""
    jmodel, variables, tmodel = _pair(True)
    images, ids, mask = _inputs(tmodel.config)
    apply = jax.jit(lambda v, im, i, m: jmodel.apply(
        v, im, i, m, train=False, return_aux=True))
    jlogits, jaux = apply(variables, jnp.asarray(images), jnp.asarray(ids),
                          jnp.asarray(mask))
    with torch.inference_mode():
        tlogits, taux = tmodel(torch.from_numpy(images), torch.from_numpy(ids).long(),
                               torch.from_numpy(mask), return_aux=True)
    return jmodel, jlogits, jaux, tmodel, tlogits, taux, (images, ids, mask)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=1e-4)


def test_backbone_matches_jax(traced):
    _, _, jaux, tmodel, _, taux, (images, _, _) = traced
    assert taux["image_features"].shape == jaux["image_features"].shape  # NHWC
    _close(taux["image_features"], jaux["image_features"])
    with torch.inference_mode():  # the backbone alone, from NHWC images
        _close(tmodel.image_encoder(torch.from_numpy(images)), jaux["image_features"])


def test_text_encoder_matches_jax(traced):
    _, _, jaux, tmodel, _, taux, (_, ids, mask) = traced
    _close(taux["text_features"], jaux["text_features"])
    _close(taux["text_pooled"], jaux["text_pooled"])
    assert mask.sum(1).min() < mask.shape[1]  # some rows hold padding


def test_fusion_and_attention_maps_match_jax(traced):
    jmodel, _, jaux, tmodel, _, taux, (images, ids, mask) = traced
    for key in ("image_projected", "attended_pooled", "text_pooled", "fused"):
        _close(taux[key], jaux[key])
    assert len(taux["cross_attention_weights"]) == 2
    for tw, jw in zip(taux["cross_attention_weights"], jaux["cross_attention_weights"]):
        _close(tw, jw, atol=1e-5)
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-5)
    s = tmodel.config.feature_spatial_size
    _close(attention_visualization(taux["cross_attention_weights"], s),
           jax_attn_vis(jaux["cross_attention_weights"], s), atol=1e-5)
    maps = get_attention_maps(tmodel, torch.from_numpy(images),
                              torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert maps["cross_attention_spatial"].shape == (len(images), ids.shape[1], s, s)


def test_eval_mode_is_deterministic_and_train_mode_drops_out(traced):
    _, _, _, tmodel, tlogits, _, (images, ids, mask) = traced
    args = (torch.from_numpy(images), torch.from_numpy(ids).long(), torch.from_numpy(mask))
    torch.testing.assert_close(forward_logits(tmodel, *args), tlogits, rtol=0, atol=0)
    trained = copy.deepcopy(tmodel).train()  # train mode updates BN running stats
    with torch.no_grad():
        train_logits, _ = trained(*args)
    assert not torch.allclose(train_logits, tlogits)


@pytest.mark.parametrize("use_attention", [True, False])
def test_full_model_logits_match_jax(use_attention):
    from vqa_tpu.models import forward_logits as jax_forward_logits

    jmodel, variables, tmodel = _pair(use_attention)
    assert tmodel.config.use_se_attention is use_attention
    images, ids, mask = _inputs(tmodel.config, batch=4, seed=1)
    jl = jax_forward_logits(jmodel, variables, jnp.asarray(images), jnp.asarray(ids),
                            jnp.asarray(mask))
    tl = forward_logits(tmodel, torch.from_numpy(images), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    assert tl.dtype == torch.float32 and tl.shape == (4, TINY["num_answers"])
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-3


# widths the JAX model runs that the kernels' fast paths do not all take:
# a stem of 12 features and one of 1 input channel (the backbone's gate
# routes both to the unfused stem), and a last stage of 6 channels, whose
# SE has C = 6 and r = 1 (the first stage of base 12 has C = 12, r = 1)
@pytest.mark.parametrize("overrides", [
    (("base_channels", 12), ("stage_channels", (12, 16, 32, 64))),
    (("in_channels", 1),),
    (("stage_channels", (8, 16, 32, 6)),),
], ids=["base12", "in_channels1", "last_stage6"])
def test_narrow_widths_match_jax(overrides):
    from vqa_tpu.models import forward_logits as jax_forward_logits

    jmodel, variables, tmodel = _pair(True, overrides)
    cfg = tmodel.config
    assert not tmodel.training
    images, ids, mask = _inputs(cfg, batch=2, seed=6)
    jl = jax_forward_logits(jmodel, variables, jnp.asarray(images), jnp.asarray(ids),
                            jnp.asarray(mask))
    tl = forward_logits(tmodel, torch.from_numpy(images), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    assert tl.shape == (2, TINY["num_answers"]) and bool(torch.isfinite(tl).all())
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_module_matches_jax(masked):
    """Eval mode without a key/value mask goes through the kernel wrapper;
    with one, through the masked plain path (-1e9 fill). Both match flax."""
    from vqa_tpu.models.cross_attention import CrossAttention as JaxCrossAttention
    from vqa_tpu_torch.models.cross_attention import CrossAttention

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 16)).astype(np.float32)
    kv_mask = (np.arange(9)[None] < np.array([[9], [4]])).astype(np.int32)
    jmod = JaxCrossAttention(embed_dim=16, num_heads=4)
    params = jmod.init(jax.random.PRNGKey(0), q, kv)
    jout, jw = jmod.apply(params, q, kv, None, kv_mask if masked else None)

    tmod = CrossAttention(16, 4).eval()
    with torch.no_grad():
        for name in ("W_q", "W_k", "W_v", "W_o"):
            kernel = np.asarray(params["params"][name]["kernel"])
            getattr(tmod, name).weight.copy_(torch.from_numpy(kernel.T.copy()))
        tout, tw = tmod(torch.from_numpy(q), torch.from_numpy(kv),
                        torch.from_numpy(kv_mask) if masked else None)
    _close(tout, jout, atol=1e-5)
    _close(tw, jw, atol=1e-6)
    if masked:
        assert float(tw[1, :, :, 4:].abs().max()) < 1e-30  # masked keys get no weight


def test_predict_topk_matches_jax():
    from vqa_tpu.models import predict_topk as jax_predict_topk
    from vqa_tpu_torch.models import predict_topk

    jmodel, variables, tmodel = _pair(True)
    images, ids, mask = _inputs(tmodel.config, batch=2, seed=2)
    jidx, jprobs = jax_predict_topk(jmodel, variables, jnp.asarray(images),
                                    jnp.asarray(ids), jnp.asarray(mask), top_k=3)
    tidx, tprobs = predict_topk(tmodel, torch.from_numpy(images),
                                torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                top_k=3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tprobs, jprobs)
