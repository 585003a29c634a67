"""Activation recomputation, the NaN check and the space-to-depth stem of
the port's trainer, on the CPU.

- ``remat="stages"`` and ``"full"`` give the gradients of ``"none"``
  within 1e-6 (the same ops recomputed), with BN's running statistics
  updated once per forward (the recomputation leaves them alone) and the
  same dropout masks replayed; an unknown mode raises ``ValueError``.
  (The JAX-parity step tests of ``tests/test_torch_training.py`` run each
  case with remat on both sides.)
- ``debug_nans``: a batch with one NaN pixel raises ``FloatingPointError``
  before the update, naming the epoch and step through the Trainer;
  without it the step runs on.
- ``stem_s2d``: the s2d stem conv against JAX's ``StemConv(s2d=True)``
  (1e-5) and the port's plain stem conv; odd sizes raise; one s2d train
  step against JAX's s2d step (the tolerances of the f32 step tests); in
  eval mode the stem kernel still runs.
- The train CLI's new flags parse as JAX's do.

oneDNN's CPU convolution backward crashes in a process that has run
XLA:CPU programs, so torch's oneDNN path is off for this module.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import init_vqa_model
from vqa_tpu.models.cnn_backbone import StemConv as JaxStemConv
from vqa_tpu.training import train as jax_train
from vqa_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.data.dataset import create_demo_loaders
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.models.cnn_backbone import StemConv
from vqa_tpu_torch.ops import stem_kernel
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.utils.config import (ModelConfig, TrainingConfig, model_config_from_dict,
                                        tiny_model_config)

B = 4


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batch(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a) for a in (
        rng.standard_normal((b, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        rng.integers(1, cfg.vocab_size, (b, cfg.max_question_length)).astype(np.int32),
        np.ones((b, cfg.max_question_length), np.int32),
        rng.integers(0, cfg.num_answers, b).astype(np.int32))]


def _step(cfg, dtype, remat, batch, accum=1, seed=5, dropout_seed=None):
    """(model after one train step from seeded weights, its metrics)."""
    model = create_vqa_model(config=cfg, device="cpu", seed=seed, dtype=dtype)
    state = port_train.TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    step = port_train.make_train_step(model, grad_accum=accum, remat=remat)
    if dropout_seed is not None:
        torch.manual_seed(dropout_seed)
    return model, step(state, *batch)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["stages", "full"])
@pytest.mark.parametrize("dtype,accum", [(torch.float32, 1), (torch.float32, 2),
                                         (torch.bfloat16, 1), (torch.bfloat16, 2)])
def test_remat_gives_the_gradients_of_none_and_updates_bn_once(remat, dtype, accum):
    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)
    batch = _batch(cfg, seed=1)
    ref, m_ref = _step(cfg, dtype, "none", batch, accum)
    got, m_got = _step(cfg, dtype, remat, batch, accum)
    assert float(m_got["loss"]) == pytest.approx(float(m_ref["loss"]), abs=1e-6)
    params = dict(got.named_parameters())
    for k, p in ref.named_parameters():
        torch.testing.assert_close(params[k].grad, p.grad, atol=1e-6, rtol=0, msg=k)
    buffers = dict(got.named_buffers())
    for k, v in ref.named_buffers():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(buffers[k], v, atol=1e-7, rtol=0, msg=k)
    assert int(got.image_encoder.stem[1].num_batches_tracked) == accum


@pytest.mark.parametrize("remat", ["stages", "full"])
def test_remat_replays_the_dropout_masks(remat):
    """Dropout on: the same dropout seed gives the same step with and
    without recomputation (the recomputation draws the masks again from
    the generator state the forward started from)."""
    cfg = dataclasses.replace(tiny_model_config(), dropout=0.3, answer_dropout=0.3)
    batch = _batch(cfg, seed=2)
    ref, m_ref = _step(cfg, torch.float32, "none", batch, dropout_seed=11)
    got, m_got = _step(cfg, torch.float32, remat, batch, dropout_seed=11)
    other, m_other = _step(cfg, torch.float32, "none", batch, dropout_seed=12)
    assert float(m_got["loss"]) == float(m_ref["loss"]) != float(m_other["loss"])
    params = dict(got.named_parameters())
    for k, p in ref.named_parameters():
        torch.testing.assert_close(params[k].grad, p.grad, atol=1e-6, rtol=0, msg=k)


def test_remat_rejects_an_unknown_mode_and_the_trainer_takes_the_config():
    model = create_vqa_model(config=tiny_model_config(), device="cpu")
    with pytest.raises(ValueError, match="remat='bogus'"):
        port_train.make_train_step(model, remat="bogus")
    train_loader, val_loader = create_demo_loaders(
        batch_size=4, eval_batch_size=4, num_samples=8, image_size=64,
        max_question_length=8, vocab_size=1000, num_answers=16)
    with pytest.raises(ValueError, match="remat='bogus'"):
        port_train.Trainer(model, train_loader, val_loader,
                           config=TrainingConfig(remat="bogus"), save_checkpoints=False)


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------

def _nan_batch(cfg):
    batch = _batch(cfg, seed=3)
    batch[0][1, 10, 20, 2] = float("nan")
    return batch


@pytest.mark.parametrize("remat", ["none", "stages"])
def test_debug_nans_stops_a_nan_batch_before_the_update(remat):
    cfg = tiny_model_config()
    model = create_vqa_model(config=cfg, device="cpu", seed=5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = port_train.TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    step = port_train.make_train_step(model, remat=remat, debug_nans=True)
    with pytest.warns(UserWarning, match="Error detected in"), \
            pytest.raises(FloatingPointError, match="returned nan values"):
        step(state, *_nan_batch(cfg))
    assert state.step == 0
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), before[k]), k
    # a finite batch still trains under the check
    m = step(state, *_batch(cfg, seed=4))
    assert np.isfinite(float(m["loss"])) and state.step == 1


def test_without_debug_nans_a_nan_batch_runs_on():
    cfg = tiny_model_config()
    model = create_vqa_model(config=cfg, device="cpu", seed=5)
    state = port_train.TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    m = port_train.make_train_step(model)(state, *_nan_batch(cfg))
    assert np.isnan(float(m["loss"])) and state.step == 1


def test_trainer_debug_nans_names_the_epoch_and_step():
    cfg = ModelConfig(**{**dataclasses.asdict(tiny_model_config()), "image_size": 32,
                         "feature_spatial_size": 1})
    train_loader, val_loader = create_demo_loaders(
        batch_size=4, eval_batch_size=4, num_samples=16, image_size=32,
        max_question_length=8, vocab_size=1000, num_answers=16)
    batches = list(train_loader)
    batches[1]["image"] = batches[1]["image"].copy()
    batches[1]["image"][0, 0, 0, 0] = np.nan
    model = create_vqa_model(config=cfg, device="cpu", seed=5)
    trainer = port_train.Trainer(model, batches, val_loader, save_checkpoints=False,
                                 debug_nans=True)
    with pytest.warns(UserWarning), \
            pytest.raises(FloatingPointError, match=r"^epoch 0, step 1: "):
        trainer.train_epoch(0)
    assert trainer.state.step == 1


# ---------------------------------------------------------------------------
# The space-to-depth stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,cin", [(64, 64, 3), (30, 18, 3), (16, 8, 1)])
def test_s2d_stem_conv_matches_jax_and_the_plain_conv(h, w, cin):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    jconv = JaxStemConv(8, s2d=True)
    variables = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])  # HWIO
    conv = StemConv(cin, 8, s2d=True)
    plain = StemConv(cin, 8)
    with torch.no_grad():
        for c in (conv, plain):
            c.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got, ref = conv(xt), plain(xt)
    assert conv.state_dict().keys() == plain.state_dict().keys() == {"weight"}
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_s2d_stem_rejects_odd_sizes():
    conv = StemConv(3, 8, s2d=True)
    for shape in ((1, 3, 63, 64), (1, 3, 64, 9)):
        with pytest.raises(ValueError, match="even H,W"):
            conv(torch.zeros(shape))


def test_s2d_model_keeps_the_state_dict_and_the_stem_kernel_in_eval():
    """Same keys and the same forward as the plain plan; in eval at a
    geometry the stem kernel takes, the kernel (here its plain version on
    the CPU) still runs, as in JAX."""
    cfg = dataclasses.replace(tiny_model_config(), dropout=0.0, answer_dropout=0.0)
    s2d = create_vqa_model(config=cfg, device="cpu", seed=2, stem_s2d=True)
    plain = create_vqa_model(config=cfg, device="cpu", seed=2)
    assert list(s2d.state_dict()) == list(plain.state_dict())
    images, ids, mask, _ = _batch(cfg, seed=7)
    with mock.patch.object(stem_kernel, "fused_stem", wraps=stem_kernel.fused_stem) as fused:
        with torch.no_grad():
            got, _ = s2d(images, ids.long(), mask)
        assert fused.call_count == 1
    with torch.no_grad():
        want, _ = plain(images, ids.long(), mask)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        s2d.train(), plain.train()
        torch.testing.assert_close(s2d(images, ids.long(), mask)[0],
                                   plain(images, ids.long(), mask)[0], atol=1e-4, rtol=0)


TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2, dropout=0.0, answer_dropout=0.0)


@functools.lru_cache(maxsize=None)
def _jax_s2d():
    jmodel = jax_create(**TINY, stem_s2d=True)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(0))
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def test_s2d_train_step_matches_jax_s2d_step():
    """Loss 1e-5; each clipped gradient within 1e-5 abs or 1e-4 of the
    tensor's max |g|; parameters within 2·lr (a first AdamW step is near
    lr·sign(g)); BN statistics 1e-5."""
    jmodel, variables = _jax_s2d()
    cfg = model_config_from_dict(model_config_dict(jmodel.config))
    model = create_vqa_model(config=cfg, device="cpu", stem_s2d=True)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    kw = dict(learning_rate=1e-4, warmup_epochs=0, num_epochs=3)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    mask = np.ones((B, 6), np.int32)
    ids = rng.integers(1, 20, (B, 6)).astype(np.int32)
    labels = rng.integers(0, 7, B).astype(np.int32)
    state = port_train.TrainState.create(model, TrainingConfig(**kw), 10)
    m = port_train.make_train_step(model)(
        state, *(torch.from_numpy(a) for a in (images, ids, mask, labels)))
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(**kw), 10)
    jstate = jax_train.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                         tx=tx, batch_stats=variables["batch_stats"])
    jstate, jm = jax_train.make_train_step(jmodel)(jstate, images, ids, mask, labels,
                                                   jax.random.PRNGKey(0))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / 0.1, adam.mu)}, cfg)
    params = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                                  "batch_stats": jax.tree_util.tree_map(
                                      np.asarray, jstate.batch_stats)}, cfg)
    for k, p in model.named_parameters():
        wg = grads[k].numpy()
        tol = max(1e-5, 1e-4 * float(np.abs(wg).max()))
        np.testing.assert_allclose(p.grad.numpy(), wg, atol=tol, rtol=0, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), params[k].numpy(), atol=2e-4 + 1e-6,
                                   rtol=0, err_msg=k)
    sd = model.state_dict()
    for k, v in params.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The CLI's flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--remat", "stages"], ["--remat", "full", "--debug-nans"], ["--stem-s2d"],
    ["--no-bf16", "--remat", "none", "--stem-s2d", "--debug-nans", "--grad-accum", "2"]])
def test_train_flags_parse_as_jax(argv):
    port = vars(port_train.parse_args(argv))
    jax_args = vars(jax_train.parse_args(argv))
    for key in ("remat", "debug_nans", "stem_s2d", "no_bf16", "grad_accum"):
        assert port[key] == jax_args[key], key
    with pytest.raises(SystemExit):
        port_train.parse_args(["--remat", "bogus"])
