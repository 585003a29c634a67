"""The port's training path against the JAX package's, on the CPU.

Tiny config of ``tests/test_torch_models.py`` with dropout off. The JAX
model is initialised, its variables carried into the port with
``state_dict_from_jax`` (strict load), and both take the same numpy batch.
JAX runs on the CPU at 'highest' matmul precision (conftest); each JAX step
function is compiled once per module.

Tolerances (f32 sums taken in another order through a few layers):
- BN running statistics: 1e-5 abs; eval logits after them: 1e-3;
- one train step: loss 1e-5; each clipped gradient within 1e-5 abs or,
  where larger, 1e-4 of that tensor's max |g|; updated parameters 2e-5
  (lr 1e-4); BN statistics 1e-5; top-1/top-5 counts exact;
- learning rate: rel 1e-6 against optax's schedule at every step;
- validation sums: 1e-4 abs (loss) and exact counts.

JAX's clipped gradients are read from its Adam state after the first
update, where mu = (1 − b1)·g.

oneDNN's CPU convolution backward crashes (SIGSEGV) in a process that has
run XLA:CPU programs, so torch's oneDNN path is off for this module; the
port then takes torch's native CPU convolutions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import forward_logits as jax_forward_logits
from vqa_tpu.models import init_vqa_model
from vqa_tpu.training import train as jax_train
from vqa_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model, forward_logits
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.utils.config import TrainingConfig, model_config_from_dict

TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2, dropout=0.0, answer_dropout=0.0)
B = 4
STEPS_PER_EPOCH = 10


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    lengths = rng.integers(2, cfg.max_question_length + 1, B)
    mask = (np.arange(cfg.max_question_length)[None] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(1, cfg.vocab_size, mask.shape) * mask).astype(np.int32)
    labels = rng.integers(0, cfg.num_answers, B).astype(np.int32)
    return images, ids, mask, labels


@functools.lru_cache(maxsize=None)
def _jax_model():
    jmodel = jax_create(**TINY)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(0))
    return jmodel, jax.tree_util.tree_map(np.asarray, variables)


def _port_model():
    jmodel, variables = _jax_model()
    cfg = model_config_from_dict(model_config_dict(jmodel.config))
    model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model


def _close_state(model, jax_tree, collections, atol):
    """Every tensor of ``jax_tree`` (flax collections) against the port's
    state_dict entry it maps to."""
    want = state_dict_from_jax({c: jax_tree[c] for c in collections}, model.config)
    got = model.state_dict()
    checked = 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked") or key.endswith(".pe"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), atol=atol, rtol=0,
                                   err_msg=key)
        checked += 1
    return checked


# ---------------------------------------------------------------------------
# BatchNorm's running statistics in training mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train_forward():
    jmodel, _ = _jax_model()

    @jax.jit
    def forward(variables, images, ids, mask):
        _, mutated = jmodel.apply(variables, images, ids, mask, train=True,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return mutated["batch_stats"]

    return forward


@pytest.mark.parametrize("forwards", [1, 3])
def test_bn_running_stats_match_flax_after_train_forwards(jax_train_forward, forwards):
    """The port's BN updates running_var with the biased batch variance, as
    flax does (the unbiased one left a stage-4 running_var 9.9e-3 off and
    the eval logits that follow 8.35e-3 off after one forward at B = 4)."""
    jmodel, variables = _jax_model()
    model = _port_model().train()
    stats = variables["batch_stats"]
    for i in range(forwards):
        images, ids, mask, _ = _batch(model.config, seed=10 + i)
        stats = jax_train_forward({"params": variables["params"], "batch_stats": stats},
                                  images, ids, mask)
        with torch.no_grad():
            model(torch.from_numpy(images), torch.from_numpy(ids).long(),
                  torch.from_numpy(mask))
    assert _close_state(model, {"batch_stats": stats}, ["batch_stats"], 1e-5) == 2 * 20
    assert int(model.image_encoder.stem[1].num_batches_tracked) == forwards

    images, ids, mask, _ = _batch(model.config, seed=20)
    jl = jax_forward_logits(jmodel, {"params": variables["params"], "batch_stats": stats},
                            images, ids, mask)
    tl = forward_logits(model.eval(), torch.from_numpy(images), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-3


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

# each case with activation recomputation off (the case's own name), and
# with remat "stages" and "full" on both sides (JAX's remat step is its
# plain one recomputed)
BASE_CASES = {"plain": (1, 0.0), "grad_accum2": (2, 0.0), "label_smoothing": (1, 0.1)}
CASES = {**{name: (*c, "none") for name, c in BASE_CASES.items()},
         **{f"{name}-remat_{r}": (*c, r) for name, c in BASE_CASES.items()
            for r in ("stages", "full")}}


@functools.lru_cache(maxsize=None)
def _jax_step(grad_accum, label_smoothing, remat="none"):
    jmodel, _ = _jax_model()
    return jax_train.make_train_step(jmodel, grad_accum=grad_accum,
                                     label_smoothing=label_smoothing, remat=remat)


def _jax_state(cfg):
    jmodel, variables = _jax_model()
    tx, _ = jax_train.make_optimizer(cfg, STEPS_PER_EPOCH)
    copy = functools.partial(jax.tree_util.tree_map, jnp.array)
    return jax_train.TrainState.create(apply_fn=jmodel.apply, params=copy(variables["params"]),
                                       tx=tx, batch_stats=copy(variables["batch_stats"]))


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0].mu


@pytest.fixture(scope="module")
def one_step():
    """Per case: (port model after one step, its metrics, JAX state after
    one step, JAX metrics)."""
    out = {}
    for name, (accum, smoothing, remat) in CASES.items():
        kw = dict(learning_rate=1e-4, warmup_epochs=0, num_epochs=3,
                  label_smoothing=smoothing, grad_accum=accum, remat=remat)
        model = _port_model()
        images, ids, mask, labels = _batch(model.config, seed=1)
        state = port_train.TrainState.create(model, TrainingConfig(**kw), STEPS_PER_EPOCH)
        step = port_train.make_train_step(model, grad_accum=accum, label_smoothing=smoothing,
                                          remat=remat)
        m = step(state, *(torch.from_numpy(a) for a in (images, ids, mask, labels)))
        jstate, jm = _jax_step(accum, smoothing, remat)(
            _jax_state(JaxTrainingConfig(**kw)), images, ids, mask, labels,
            jax.random.PRNGKey(0))
        out[name] = (model, m, jstate, jm)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_loss_and_counts_match_jax(one_step, case):
    model, m, jstate, jm = one_step[case]
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert int(m["correct1"]) == int(jm["correct1"])
    assert int(m["correct5"]) == int(jm["correct5"])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_clipped_gradients_match_jax(one_step, case):
    model, _, jstate, _ = one_step[case]
    b1 = TrainingConfig().adam_b1
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / (1 - b1),
                                   _adam_mu(jstate.opt_state))
    want = state_dict_from_jax({"params": grads}, model.config)
    params = dict(model.named_parameters())
    assert len(params) == sum(1 for k in want if k in params)
    norm = 0.0
    for key, p in params.items():
        g, wg = p.grad.numpy(), want[key].numpy()
        tol = max(1e-5, 1e-4 * float(np.abs(wg).max()))
        np.testing.assert_allclose(g, wg, atol=tol, rtol=0, err_msg=key)
        norm += float((g.astype(np.float64) ** 2).sum())
    assert np.sqrt(norm) <= 1.0 + 1e-5  # clipped to the global-norm bound


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_params_and_bn_stats_match_jax(one_step, case):
    """Parameters after the step within 2e-5 of JAX's, but for weights
    whose clipped gradient is below 1e-7 (at most 1 in 10,000): a first
    AdamW step moves a weight by lr·g/(|g| + 1e-8), so there an f32
    gradient difference of 1e-9 moves the update by up to ~1e-5. Every
    weight, those included, is held to the AdamW update of each package's
    own gradient, p·(1 − lr·wd) − lr·g/(|g| + eps), within f32 rounding
    (1e-7 + 1e-6·|p|)."""
    model, _, jstate, _ = one_step[case]
    cfg = TrainingConfig()
    lr, wd = 1e-4, cfg.weight_decay
    _, variables = _jax_model()
    tree = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}
    want = state_dict_from_jax({"params": tree["params"]}, model.config)
    before = state_dict_from_jax({"params": variables["params"]}, model.config)
    jgrads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / (1 - cfg.adam_b1), _adam_mu(jstate.opt_state))},
        model.config)
    total = small = 0
    for key, p in model.named_parameters():
        got, exp, p0 = p.detach().numpy(), want[key].numpy(), before[key].numpy()
        g, jg = p.grad.numpy(), jgrads[key].numpy()
        off = np.abs(got - exp) > 2e-5
        assert (np.abs(jg[off]) < 1e-7).all(), (key, jg[off])
        for new, grad in ((got, g), (exp, jg)):
            step = p0 * (1 - lr * wd) - lr * grad / (np.abs(grad) + 1e-8)
            np.testing.assert_allclose(new, step, atol=1e-7, rtol=1e-6, err_msg=key)
        total, small = total + got.size, small + int(off.sum())
    assert small <= 1e-4 * total, (small, total)
    assert _close_state(model, tree, ["batch_stats"], 1e-5) == 40
    # BN counted one update per microbatch
    accum = CASES[case][0]
    assert int(model.image_encoder.stem[1].num_batches_tracked) == accum


def test_three_steps_with_warmup_follow_jax():
    """warmup 1 epoch of 2 steps: lr 0, 5e-5, then the cosine; the loss of
    each step and the parameters after the last match."""
    kw = dict(learning_rate=1e-4, warmup_epochs=1, num_epochs=3)
    model = _port_model()
    state = port_train.TrainState.create(model, TrainingConfig(**kw), 2)
    step = port_train.make_train_step(model)
    jmodel, _ = _jax_model()
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(**kw), 2)
    _, variables = _jax_model()
    jstate = jax_train.TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                         tx=tx, batch_stats=variables["batch_stats"])
    jstep = _jax_step(1, 0.0)
    for i in range(3):
        batch = _batch(model.config, seed=30 + i)
        m = step(state, *(torch.from_numpy(a) for a in batch))
        jstate, jm = jstep(jstate, *batch, jax.random.PRNGKey(0))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5, i
    assert state.step == 3
    tree = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}
    _close_state(model, tree, ["params"], 2e-5)
    _close_state(model, tree, ["batch_stats"], 1e-5)


def test_grad_accum_rejects_indivisible_batch_and_remat_an_unknown_mode():
    model = _port_model()
    state = port_train.TrainState.create(model, TrainingConfig(), STEPS_PER_EPOCH)
    batch = [torch.from_numpy(a) for a in _batch(model.config, seed=2)]
    with pytest.raises(ValueError, match="not divisible"):
        port_train.make_train_step(model, grad_accum=3)(state, *batch)
    match = "expected 'none', 'full' or 'stages'"
    with pytest.raises(ValueError, match=match):
        port_train.make_train_step(model, remat="bogus")
    # JAX's raises when its step is traced
    jmodel, _ = _jax_model()
    with pytest.raises(ValueError, match=match):
        jax_train.make_train_step(jmodel, remat="bogus")(
            _jax_state(JaxTrainingConfig()), *_batch(model.config, seed=2),
            jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("granularity,warmup,epochs,spe", [
    ("step", 2, 30, 10), ("step", 0, 30, 10), ("step", 3, 4, 7), ("step", 1, 1, 5),
    ("epoch", 2, 30, 10), ("epoch", 0, 12, 3), ("epoch", 2, 5, 0),
])
def test_schedule_equals_optax(granularity, warmup, epochs, spe):
    """At every step, within 1e-6 of the peak rate. The port computes the
    schedule in double precision; optax in f32, whose own rounding (of
    1 + cos near −1 among others) exceeds 1e-6 of the value near the
    floor, so a relative bound would measure optax's rounding."""
    peak = 3e-4
    kw = dict(learning_rate=peak, min_lr=1e-6, warmup_epochs=warmup, num_epochs=epochs,
              lr_schedule_granularity=granularity)
    _, jsched = jax_train.make_optimizer(JaxTrainingConfig(**kw), spe)
    sched = port_train.make_schedule(TrainingConfig(**kw), spe)
    steps = np.arange(0, (epochs + 2) * max(spe, 1) + 1)
    want = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps)), np.float64)
    got = np.asarray([sched(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    assert got[-1] == pytest.approx(1e-6 if epochs * spe else got[-1])


def test_optimizer_decays_parameters_only():
    model = _port_model()
    optimizer, _ = port_train.make_optimizer(model, TrainingConfig(), STEPS_PER_EPOCH)
    in_optimizer = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert in_optimizer == {id(p) for p in model.parameters()}
    assert all(id(b) not in in_optimizer for b in model.buffers())
    assert optimizer.param_groups[0]["weight_decay"] == 0.01
    assert optimizer.param_groups[0]["eps"] == 1e-8


def test_clipping_keeps_gradients_under_the_bound():
    """Below the bound the gradients are untouched (optax keeps g as is;
    torch's clip_grad_norm_ would scale by bound/(norm + 1e-6))."""
    model = _port_model()
    state = port_train.TrainState.create(model, TrainingConfig(grad_clip_norm=1e6),
                                         STEPS_PER_EPOCH)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    before = [p.grad.clone() for p in model.parameters()]
    state.clip_gradients()
    state.update()
    assert all(torch.equal(a, p.grad) for a, p in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# Validation and evaluation steps
# ---------------------------------------------------------------------------

def test_val_step_sums_and_per_type_sums_match_jax():
    jmodel, variables = _jax_model()
    model = _port_model()
    images, ids, mask, labels = _batch(model.config, seed=3)
    valid_mask = np.array([1, 1, 1, 0], np.int32)
    type_ids = np.array([0, 2, 3, 1], np.int32)  # 3 = the overflow bucket of 3 types
    jout = jax_train.make_val_step(jmodel, num_types=3)(
        variables["params"], variables["batch_stats"], images, ids, mask, labels,
        valid_mask, type_ids)
    out = port_train.make_val_step(model, num_types=3)(
        *(torch.from_numpy(a) for a in (images, ids, mask, labels, valid_mask, type_ids)))
    assert set(out) == set(jout)
    assert abs(float(out["loss_sum"]) - float(jout["loss_sum"])) <= 1e-4
    for k in ("correct1", "correct5", "n"):
        assert float(out[k]) == float(jout[k]), k
    for k in ("type_correct", "type_total"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    assert out["type_total"].tolist() == [1.0, 0.0, 1.0]  # overflow and pad dropped


def test_eval_step_matches_jax():
    jmodel, variables = _jax_model()
    model = _port_model()
    images, ids, mask, labels = _batch(model.config, seed=4)
    jout = jax_train.make_eval_step(jmodel)(variables["params"], variables["batch_stats"],
                                            images, ids, mask, labels)
    out = port_train.make_eval_step(model)(
        *(torch.from_numpy(a) for a in (images, ids, mask, labels)))
    np.testing.assert_allclose(out["loss_vec"].numpy(), np.asarray(jout["loss_vec"]), atol=1e-4)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-3)
    for k in ("pred", "correct1", "correct5"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))


# ---------------------------------------------------------------------------
# The port's trained weights in JAX
# ---------------------------------------------------------------------------

def test_port_trained_weights_load_in_jax(one_step):
    from vqa_tpu.compat.torch_import import convert_torch_state_dict

    model = one_step["plain"][0]
    variables = convert_torch_state_dict(model.state_dict())
    jmodel, _ = _jax_model()
    images, ids, mask, _ = _batch(model.config, seed=5)
    jl = jax_forward_logits(jmodel, variables, images, ids, mask)
    tl = forward_logits(model.eval(), torch.from_numpy(images), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= 1e-3
