"""Weights carried from the JAX package into the port.

``state_dict_from_jax`` must agree key for key and value for value with
the JAX package's own exporter and load strictly into the port's model;
at full width the port must have the JAX model's parameter count, per
component (JAX counts from ``jax.eval_shape``: no compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.compat.torch_export import flax_to_torch_state_dict
from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import init_vqa_model
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import count_parameters, create_vqa_model
from vqa_tpu_torch.utils.config import ModelConfig, model_config_from_dict
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=2,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2)


@pytest.mark.parametrize("ablation", [{}, {"use_attention": False, "use_gating": False}])
def test_state_dict_matches_exporter_and_loads_strictly(ablation):
    jmodel = jax_create(**TINY, **ablation)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(0))
    cfg = model_config_from_dict(model_config_dict(jmodel.config))
    ref = flax_to_torch_state_dict(variables, jmodel.config)
    got = state_dict_from_jax(variables, cfg)
    assert set(got) == set(ref)
    for key, want in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
        assert got[key].is_contiguous()

    model = create_vqa_model(config=cfg, device="cpu")
    assert set(model.state_dict()) == set(got)
    model.load_state_dict(got, strict=True)
    for key, value in model.state_dict().items():
        assert value.shape == got[key].shape, key


def _jax_counts(cfg: JaxModelConfig):
    model = jax_create(config=cfg)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    ids = jnp.zeros((1, cfg.max_question_length), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), img, ids, ids)
    counts = {
        name: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
        for name, tree in shapes["params"].items()
    }
    counts["total"] = sum(counts.values())
    return counts


def test_full_width_parameter_count_matches_jax():
    jax_counts = _jax_counts(JaxModelConfig())
    model = create_vqa_model(config=ModelConfig(), device="cpu")
    counts = count_parameters(model)
    assert counts == jax_counts
    assert counts["total"] == 19_310_316


def test_seeded_init_is_reproducible():
    cfg = model_config_from_dict(TINY)
    a = create_vqa_model(config=cfg, device="cpu", seed=3).state_dict()
    b = create_vqa_model(config=cfg, device="cpu", seed=3).state_dict()
    c = create_vqa_model(config=cfg, device="cpu", seed=4).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a["answer_head.classifier.0.weight"],
                           c["answer_head.classifier.0.weight"])
    emb = a["text_encoder.token_embedding.weight"]
    assert torch.count_nonzero(emb[cfg.pad_idx]) == 0  # zero PAD row


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_vqa_model(config=model_config_from_dict(TINY))
