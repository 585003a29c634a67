"""The port's bf16 training against the JAX package's, on the CPU.

Tiny config of ``tests/test_torch_training.py`` with dropout off. The JAX
model is initialised in f32, its variables carried into the port with
``state_dict_from_jax``; the JAX bf16 model (``create_vqa_model(dtype=
jnp.bfloat16)``) and the port's bf16 model (``create_vqa_model(dtype=
torch.bfloat16)``) start from those same f32 weights and take the same
numpy batch.

The JAX steps are compiled with XLA's ``xla_allow_excess_precision`` off
(``_strict``). On by default, it lets XLA:CPU keep f32 between fused bf16
ops and skip roundings that the JAX model's dtype policy names; the port
rounds at every op, as eager PyTorch does. With it on, the port's own
bf16 noise at grad_accum 2 was 2.2-2.4x JAX's on two of the three batches,
and the last Dense's bias gradient 11-22x JAX's noise away: the port
rounds the logits' cotangent to bf16 where XLA did not.

The bound calibrates itself on JAX's bf16 noise alone, the distance of
JAX's bf16 step from its f32 step on the same inputs. On this tiny model
at random initialisation that noise is large (per gradient tensor a median
of ~0.2-0.45 of the tensor's norm) and lumpy: a ReLU input near zero flips
its mask in one rounding and not the other. Per tensor t, in L2:

    |port_bf16 - jax_bf16| <= 2 |jax_bf16 - jax_f32| + m |jax_f32|

with m the median over the tensors of JAX's relative noise (the floor: the
typical bf16 noise of the model). A stated few readings over the three
batches may exceed it, each within ``EXCEPTION_CAP`` times it
(``ALLOWED``, from the readings: at most 2 of the 384 gradient readings of
a grad_accum over 1, 3 or 8 CPU threads, at most 1.98x; none of the 120
BN readings, at most 0.41x). What the port's rounding adds beyond that is
held apart: its own median relative noise, averaged over the three
batches, at most twice JAX's. Planted faults (``FAULTS``) show what the
bound catches: a training-mode weight cast that does not carry the
gradient to the f32 parameter, and BN's unbiased running variance. A
fault at one rounding point (LayerNorm or the attention softmax in bf16,
the CE on bf16 logits, even one head layer rounded to fp8) moved no
reading past the bound: at this size such faults are below bf16's own
noise, and ``test_batchnorm_reduces_a_bf16_input_in_f32_as_flax`` pins
the BN statistics' rounding point on its own. The loss: within twice
JAX's noise plus 2^-8 of the loss (one bf16 rounding). Parameters after a
first AdamW step: within 2·lr (+1e-6), since the step is near lr·sign(g).
Gradients are read from JAX's Adam state after the first update, where
mu = (1 − b1)·g.

Beside the step: BN statistics after bf16 train forwards (reduced in f32,
as flax's BatchNorm reduces them), three steps with warmup, the val step,
a resume, the eval weight copies after a step, and the train CLI's dtype
choice.

oneDNN's CPU convolution backward crashes (SIGSEGV) in a process that has
run XLA:CPU programs, so torch's oneDNN path is off for this module.
"""

import functools
import io
from contextlib import ExitStack, redirect_stdout
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from vqa_tpu.models import create_vqa_model as jax_create
from vqa_tpu.models import forward_logits as jax_forward_logits
from vqa_tpu.models import init_vqa_model
from vqa_tpu.training import train as jax_train
from vqa_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.models import layers
from vqa_tpu_torch.models.cnn_backbone import BatchNorm2d
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.utils.config import TrainingConfig, model_config_from_dict
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
TINY = dict(vocab_size=20, num_answers=7, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=64, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=2, dropout=0.0, answer_dropout=0.0)
B = 4
STEPS_PER_EPOCH = 10
LR = 1e-4


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
def _jax_models():
    """(f32 model, bf16 model, the f32 variables both start from)."""
    j32 = jax_create(**TINY)
    j16 = jax_create(**TINY, dtype=jnp.bfloat16)
    variables = init_vqa_model(j32, jax.random.PRNGKey(0))
    return j32, j16, jax.tree_util.tree_map(np.asarray, variables)


def _cfg():
    return model_config_from_dict(model_config_dict(_jax_models()[0].config))


def _port_model(dtype):
    _, _, variables = _jax_models()
    cfg = _cfg()
    model = create_vqa_model(config=cfg, device="cpu", dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model


def _strict(jitted):
    """``jitted`` compiled to round at every op (module docstring)."""
    return jax.jit(jitted.__wrapped__, compiler_options={"xla_allow_excess_precision": False})


@functools.lru_cache(maxsize=None)
def _jax_step(bf16: bool, grad_accum: int):
    j32, j16, _ = _jax_models()
    return _strict(jax_train.make_train_step(j16 if bf16 else j32, grad_accum=grad_accum))


def _jax_state(bf16: bool, cfg):
    j32, j16, variables = _jax_models()
    tx, _ = jax_train.make_optimizer(cfg, STEPS_PER_EPOCH)
    copy = functools.partial(jax.tree_util.tree_map, jnp.array)
    return jax_train.TrainState.create(
        apply_fn=(j16 if bf16 else j32).apply, params=copy(variables["params"]), tx=tx,
        batch_stats=copy(variables["batch_stats"]))


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0].mu


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_result(state, metrics):
    """(loss, clipped gradients, BN statistics, parameters) as port keys."""
    cfg = _cfg()
    b1 = JaxTrainingConfig().adam_b1
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / (1 - b1),
                                   _adam_mu(state.opt_state))
    names = {k for k, _ in _port_model(torch.float32).named_parameters()}

    def as_np(tree, keep):
        return {k: v.numpy().astype(np.float64) for k, v in state_dict_from_jax(tree, cfg).items()
                if keep(k)}

    return (float(metrics["loss"]),
            as_np({"params": grads}, names.__contains__),
            as_np({"batch_stats": _np(state.batch_stats)}, lambda k: "running" in k),
            as_np({"params": _np(state.params)}, names.__contains__))


def _port_result(model, metrics):
    """As ``_jax_result``; a parameter the backward did not reach has a
    zero gradient."""
    sd = model.state_dict()
    return (float(metrics["loss"]),
            {k: (torch.zeros_like(p) if p.grad is None else p.grad).double().numpy()
             for k, p in model.named_parameters()},
            {k: v.double().numpy() for k, v in sd.items() if "running" in k},
            {k: p.detach().double().numpy() for k, p in model.named_parameters()})


def _norm(a):
    return float(np.linalg.norm(a))


def _rel_noise(noisy, ref):
    """Median over the tensors of |noisy - ref| / |ref| (exact zeros, such
    as the gradient of a one-unit SE bottleneck behind a dead ReLU, left
    out)."""
    return float(np.median([_norm(noisy[k] - ref[k]) / _norm(ref[k])
                            for k in ref if _norm(ref[k]) > 0]))


# readings over the three batches allowed past the bound, and how far
EXCEPTION_CAP = 4.0
ALLOWED = {"grad": 3, "bn": 1}


def beyond_noise(got, want, ref):
    """Per tensor ``|got - want| <= 2 |want - ref| + m |ref|`` with m the
    median relative noise of ``want`` (module docstring); returns the
    tensors past it as (error / bound, name)."""
    m = _rel_noise(want, ref)
    out = []
    for k in ref:
        err, bound = _norm(got[k] - want[k]), 2 * _norm(want[k] - ref[k]) + m * _norm(ref[k])
        if err > bound:
            out.append((err / bound if bound > 0 else np.inf, k))
    return out


def held_to_noise(readings, kind):
    """``readings``: (got, want, ref) of each batch. Returns what fails:
    more than ``ALLOWED[kind]`` tensors past the bound over the batches, or
    one past ``EXCEPTION_CAP`` times it."""
    past = [x for r in readings for x in beyond_noise(*r)]
    failures = [f"{k}: {ratio:.2f}x the bound" for ratio, k in past if ratio > EXCEPTION_CAP]
    if len(past) > ALLOWED[kind]:
        failures.append(f"{len(past)} {kind} tensors past the bound (allowed "
                        f"{ALLOWED[kind]}): {sorted(past, reverse=True)[:5]}")
    return failures


def _loss_ok(got, want, ref):
    return abs(got - want) <= 2 * abs(want - ref) + 2 ** -8 * abs(want)


# ---------------------------------------------------------------------------
# One bf16 train step
# ---------------------------------------------------------------------------

ACCUM = [1, 2]
SEEDS = (1, 2, 3)


def _port_step(accum, data, dtype=BF16):
    kw = dict(learning_rate=LR, warmup_epochs=0, num_epochs=3, grad_accum=accum)
    model = _port_model(dtype)
    state = port_train.TrainState.create(model, TrainingConfig(**kw), STEPS_PER_EPOCH)
    m = port_train.make_train_step(model, grad_accum=accum)(
        state, *(torch.from_numpy(a) for a in data))
    return _port_result(model, m), model


@pytest.fixture(scope="module")
def bf16_step():
    """Per grad_accum, per batch seed: the JAX f32 and bf16 steps and the
    port's f32 and bf16 steps from the same weights, and the port's bf16
    model after its step."""
    out = {}
    for accum in ACCUM:
        kw = dict(learning_rate=LR, warmup_epochs=0, num_epochs=3, grad_accum=accum)
        for seed in SEEDS:
            data = _batch(_cfg(), seed=seed)
            runs = {}
            for name, bf16 in (("jax32", False), ("jax16", True)):
                state, m = _jax_step(bf16, accum)(_jax_state(bf16, JaxTrainingConfig(**kw)),
                                                 *data, jax.random.PRNGKey(0))
                runs[name] = _jax_result(state, m)
            runs["port32"], _ = _port_step(accum, data, torch.float32)
            runs["port16"], model = _port_step(accum, data)
            out[accum, seed] = (runs, model)
    return out


def _step_failures(runs_of_seeds, part, kind):
    """``held_to_noise`` of the port's bf16 ``part`` (1 gradients, 2 BN
    statistics) over the batches."""
    return held_to_noise([(r["port16"][part], r["jax16"][part], r["jax32"][part])
                          for r in runs_of_seeds], kind)


@pytest.mark.parametrize("accum", ACCUM)
def test_bf16_train_step_loss_matches_jax(bf16_step, accum):
    for seed in SEEDS:
        runs, _ = bf16_step[accum, seed]
        got, want, ref = runs["port16"][0], runs["jax16"][0], runs["jax32"][0]
        assert _loss_ok(got, want, ref), (seed, got, want, ref)
        assert got != runs["port32"][0]  # the step really ran in bf16


@pytest.mark.parametrize("accum", ACCUM)
def test_bf16_train_step_clipped_gradients_match_jax(bf16_step, accum):
    """Per tensor within the bound of JAX's own bf16 noise (module
    docstring); the port's own noise, averaged over the batches, at most
    twice JAX's."""
    own, jax_own = [], []
    for seed in SEEDS:
        runs, model = bf16_step[accum, seed]
        grads = {k: v[1] for k, v in runs.items()}
        own.append(_rel_noise(grads["port16"], grads["port32"]))
        jax_own.append(_rel_noise(grads["jax16"], grads["jax32"]))
        # the gradients that the clip and AdamW see are f32, clipped to the bound
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())
        assert np.sqrt(sum((g ** 2).sum() for g in grads["port16"].values())) <= 1 + 1e-5
    failures = _step_failures([bf16_step[accum, seed][0] for seed in SEEDS], 1, "grad")
    assert not failures, (own, jax_own, failures)
    assert 0 < np.mean(own) <= 2 * np.mean(jax_own), (own, jax_own)


@pytest.mark.parametrize("accum", ACCUM)
def test_bf16_train_step_params_and_bn_stats_match_jax(bf16_step, accum):
    failures = _step_failures([bf16_step[accum, seed][0] for seed in SEEDS], 2, "bn")
    assert not failures, failures
    for seed in SEEDS:
        runs, model = bf16_step[accum, seed]
        got, want = runs["port16"][3], runs["jax16"][3]
        assert max(np.abs(got[k] - want[k]).max() for k in want) <= 2 * LR + 1e-6
        assert all(p.dtype == torch.float32 for p in model.parameters())
        # the buffers a checkpoint holds (BN statistics, pe) stay f32; the
        # bf16 eval copies beside them are not part of it
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in model.state_dict().values())
        assert all(b.dtype == torch.bfloat16 for n, b in model.named_buffers()
                   if n.rsplit(".", 1)[-1].startswith("compute_"))
        assert int(model.image_encoder.stem[1].num_batches_tracked) == accum


def _detached_cast(self, name):
    copy = getattr(self, "compute_" + name)
    if copy is not None:
        return copy
    t = getattr(self, name)
    return t if t is None else t.detach().to(self.compute_dtype)


def _unbiased_bn(self, x):
    if not self.training:
        return torch.nn.BatchNorm2d.forward(self, x)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=1)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


# planted faults: (what is patched, the part of the step it moves, its kind)
FAULTS = {
    "weight_cast_without_gradient": (
        lambda: mock.patch.object(layers.ComputeCopies, "compute", _detached_cast), 1, "grad"),
    "bn_unbiased_running_variance": (
        lambda: mock.patch.object(BatchNorm2d, "forward", _unbiased_bn), 2, "bn"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bf16_step_bound_catches_a_planted_fault(bf16_step, fault):
    """The bound of the two tests above fails the port's bf16 step with a
    planted fault, at one grad_accum at least."""
    patch, part, kind = FAULTS[fault]
    caught = {}
    for accum in ACCUM:
        readings = []
        for seed in SEEDS:
            runs = dict(bf16_step[accum, seed][0])
            with ExitStack() as stack:
                stack.enter_context(patch())
                runs["port16"], _ = _port_step(accum, _batch(_cfg(), seed=seed))
            readings.append(runs)
        caught[accum] = _step_failures(readings, part, kind)
    assert any(caught.values()), caught


# ---------------------------------------------------------------------------
# BatchNorm's running statistics in bf16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train_forward():
    """Per bf16 flag: JAX's train-mode forward → its updated batch_stats."""
    j32, j16, _ = _jax_models()

    def forward_of(model):
        @jax.jit
        def forward(variables, images, ids, mask):
            _, mutated = model.apply(variables, images, ids, mask, train=True,
                                     mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
            return mutated["batch_stats"]

        return _strict(forward)

    return {False: forward_of(j32), True: forward_of(j16)}


@pytest.mark.parametrize("forwards", [1, 3])
def test_bf16_bn_running_stats_match_flax_after_train_forwards(jax_train_forward, forwards):
    """After bf16 train-mode forwards, the port's running statistics are
    within the bound of flax's bf16 noise (its bf16 forwards against its
    f32 ones), and f32."""
    _, _, variables = _jax_models()
    model = _port_model(BF16).train()
    stats = {bf16: variables["batch_stats"] for bf16 in (False, True)}
    for i in range(forwards):
        images, ids, mask, _ = _batch(model.config, seed=10 + i)
        for bf16 in stats:
            stats[bf16] = jax_train_forward[bf16](
                {"params": variables["params"], "batch_stats": stats[bf16]}, images, ids, mask)
        with torch.no_grad():
            model(torch.from_numpy(images), torch.from_numpy(ids).long(), torch.from_numpy(mask))
    cfg = model.config
    want, ref = ({k: v.numpy().astype(np.float64) for k, v in state_dict_from_jax(
        {"batch_stats": _np(stats[bf16])}, cfg).items() if "running" in k} for bf16 in (True, False))
    got = {k: v.double().numpy() for k, v in model.state_dict().items() if "running" in k}
    assert len(got) == 2 * 20
    failures = held_to_noise([(got, want, ref)], "bn")
    assert not failures, failures
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items() if "running" in k)
    assert int(model.image_encoder.stem[1].num_batches_tracked) == forwards


def test_batchnorm_reduces_a_bf16_input_in_f32_as_flax():
    """One BN over a bf16 input: the running statistics are flax's (its
    BatchNorm with dtype bf16, f32 reductions) within f32 rounding, and
    not the batch statistics rounded to bf16."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 5, 6, 8)) * 3 + 1.7, jnp.bfloat16)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                            dtype=jnp.bfloat16)
    variables = flax_bn.init(jax.random.PRNGKey(0), x)
    y, mutated = flax_bn.apply(variables, x, mutable=["batch_stats"])
    want_mean = np.asarray(mutated["batch_stats"]["mean"])
    want_var = np.asarray(mutated["batch_stats"]["var"])

    bn = BatchNorm2d(8, eps=1e-5).train()
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16).permute(0, 3, 1, 2)
    out = bn(xt)
    assert out.dtype == BF16 and bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, atol=1e-6, rtol=1e-5)
    # rounding the batch statistics to bf16 first would be off by more
    mean16 = xt.float().mean(dim=(0, 2, 3)).to(BF16).float()
    assert np.abs(0.1 * mean16.numpy() - want_mean).max() > 1e-5
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(y.astype(jnp.float32)), atol=2 ** -7, rtol=2 ** -7)


# ---------------------------------------------------------------------------
# Three steps, validation, resume, the eval copies
# ---------------------------------------------------------------------------

def test_three_bf16_steps_with_warmup_follow_jax():
    """warmup 1 epoch of 2 steps: lr 0, 5e-5, then the cosine; the loss of
    each step within the bound, and the parameters after the last within
    2x the summed learning rates of JAX's (each AdamW step moves a weight
    by at most ~lr)."""
    kw = dict(learning_rate=LR, warmup_epochs=1, num_epochs=3)
    model = _port_model(BF16)
    state = port_train.TrainState.create(model, TrainingConfig(**kw), 2)
    step = port_train.make_train_step(model)
    jstates = {bf16: None for bf16 in (False, True)}
    for bf16 in jstates:
        _, _, variables = _jax_models()
        tx, _ = jax_train.make_optimizer(JaxTrainingConfig(**kw), 2)
        j32, j16, _ = _jax_models()
        jstates[bf16] = jax_train.TrainState.create(
            apply_fn=(j16 if bf16 else j32).apply, params=variables["params"], tx=tx,
            batch_stats=variables["batch_stats"])
    lrs = []
    for i in range(3):
        batch = _batch(model.config, seed=30 + i)
        lrs.append(state.schedule(state.step))
        m = step(state, *(torch.from_numpy(a) for a in batch))
        losses = {}
        for bf16 in jstates:
            jstates[bf16], jm = _jax_step(bf16, 1)(jstates[bf16], *batch, jax.random.PRNGKey(0))
            losses[bf16] = float(jm["loss"])
        assert _loss_ok(float(m["loss"]), losses[True], losses[False]), (i, m, losses)
    assert state.step == 3 and lrs[0] == 0.0
    want = state_dict_from_jax({"params": _np(jstates[True].params)}, model.config)
    err = max(float((p.detach() - want[k]).abs().max()) for k, p in model.named_parameters())
    assert err <= 2 * sum(lrs) + 1e-6, (err, lrs)


def test_bf16_val_step_matches_jax():
    """The port's bf16 val step (eval mode: the kernels' bf16 forms, here
    their plain versions on the CPU) against JAX's bf16 val step: the loss
    sum within the bound, and the top-1 count equal up to the rows whose
    top-2 margin in JAX's bf16 logits is within twice its logits' noise."""
    j32, j16, variables = _jax_models()
    model = _port_model(BF16)
    images, ids, mask, labels = _batch(model.config, seed=3)
    valid = np.array([1, 1, 1, 0], np.int32)
    out = {}
    for name, jm in (("jax32", j32), ("jax16", j16)):
        out[name] = _strict(jax_train.make_val_step(jm))(
            variables["params"], variables["batch_stats"], images, ids, mask, labels, valid)
    got = port_train.make_val_step(model)(
        *(torch.from_numpy(a) for a in (images, ids, mask, labels, valid)))
    assert set(got) == set(out["jax16"])
    assert _loss_ok(float(got["loss_sum"]), float(out["jax16"]["loss_sum"]),
                    float(out["jax32"]["loss_sum"]))
    assert float(got["n"]) == 3.0
    l16 = np.asarray(jax_forward_logits(j16, variables, images, ids, mask), np.float64)
    l32 = np.asarray(jax_forward_logits(j32, variables, images, ids, mask), np.float64)
    s = -np.sort(-l16, axis=-1)
    close = int(((s[:, 0] - s[:, 1]) <= 2 * np.abs(l16 - l32).max())[valid == 1].sum())
    for k in ("correct1", "correct5"):
        assert abs(float(got[k]) - float(out["jax16"][k])) <= close, k


def _demo_trainer(tmp_path, seed, epochs=2):
    from vqa_tpu_torch.data.dataset import create_demo_loaders
    from vqa_tpu_torch.utils.config import ModelConfig

    train_loader, val_loader = create_demo_loaders(
        batch_size=4, eval_batch_size=4, num_samples=16, image_size=32,
        max_question_length=6, vocab_size=50, num_answers=8)
    cfg = ModelConfig(**{**TINY, "image_size": 32, "vocab_size": 50, "num_answers": 8,
                         "feature_spatial_size": 1})
    model = create_vqa_model(config=cfg, device="cpu", seed=seed, dtype=BF16)
    tcfg = TrainingConfig(num_epochs=epochs, batch_size=4, warmup_epochs=0, learning_rate=1e-3)
    return port_train.Trainer(model, train_loader, val_loader, config=tcfg,
                              checkpoint_dir=str(tmp_path), seed=3)


def test_bf16_resume_takes_the_uninterrupted_step_and_saves_f32(tmp_path):
    """A bf16 run saves f32 weights and statistics under the f32 model's
    keys; a fresh bf16 Trainer resumed from them takes the same next epoch
    as the run that went on."""
    from vqa_tpu_torch.training import checkpoint as ckpt_lib

    run = _demo_trainer(tmp_path, seed=0)
    run.train_epoch(0)
    run.validate()
    run.save("latest", 0)
    run.train_loader.set_epoch(1)
    second = run.train_epoch(1)
    payload, _, _ = ckpt_lib.load_checkpoint(str(tmp_path), "latest")
    f32_keys = list(create_vqa_model(config=run.model.config, device="cpu").state_dict())
    assert list(payload["model_state_dict"]) == f32_keys
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in payload["model_state_dict"].values())

    resumed = _demo_trainer(tmp_path, seed=7)
    resumed.resume("latest")
    assert resumed.model.dtype == BF16 and resumed.state.step == run.state.step // 2
    resumed.train_loader.set_epoch(1)
    again = resumed.train_epoch(1)
    assert np.isfinite(second["train_loss"])
    assert abs(again["train_loss"] - second["train_loss"]) <= 1e-6
    for (k, a), b in zip(run.model.state_dict().items(), resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=k)


def test_bf16_eval_copies_follow_each_optimizer_step():
    """Training mode reads no weight copy (each forward casts the f32
    parameter); leaving it refreshes the copies in place from the stepped
    weights, so the eval forward after a step is that of a bf16 model
    loaded with them."""
    model = _port_model(BF16)
    state = port_train.TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    step = port_train.make_train_step(model)
    batch = [torch.from_numpy(a) for a in _batch(model.config, seed=5)]
    fc1 = model.text_encoder.layers[0].ffn.fc1
    before = fc1.compute_weight.clone()
    ptr = fc1.compute_weight.data_ptr()
    step(state, *batch)
    assert model.training and fc1.compute("weight") is not fc1.compute_weight
    assert torch.equal(fc1.compute_weight, before)  # not refreshed in training mode
    val = port_train.make_val_step(model)
    valid = torch.ones(B, dtype=torch.int32)
    out = val(*batch, valid)
    assert not model.training
    assert torch.equal(fc1.compute_weight, fc1.weight.detach().to(BF16))
    assert not torch.equal(fc1.compute_weight, before)
    assert fc1.compute_weight.data_ptr() == ptr
    fresh = create_vqa_model(config=model.config, device="cpu", dtype=BF16)
    fresh.load_state_dict(model.state_dict())
    ref = port_train.make_val_step(fresh)(*batch, valid)
    assert float(out["loss_sum"]) == float(ref["loss_sum"])
    # a forward outside inference mode may take the copies made inside it
    with torch.no_grad():
        model(batch[0], batch[1].long(), batch[2])


# ---------------------------------------------------------------------------
# The train CLI's dtype policy
# ---------------------------------------------------------------------------

class _Built(Exception):
    pass


@pytest.mark.parametrize("device,flags,want", [
    ("cuda", (), BF16), ("cuda", ("--no-bf16",), torch.float32),
    ("cpu", (), torch.float32), ("cpu", ("--no-bf16",), torch.float32)])
def test_train_cli_dtype_policy(device, flags, want):
    """bf16 on the card unless --no-bf16, f32 on the CPU; logged. (The
    card is stood in for: the CLI stops once it has built the model.)"""
    seen = {}

    def build(**kw):
        seen.update(kw)
        raise _Built

    log = io.StringIO()
    with mock.patch.object(port_train, "resolve_device",
                           lambda d: torch.device(device, 0) if device == "cuda"
                           else torch.device("cpu")), \
            mock.patch.object(port_train, "create_vqa_model", build), redirect_stdout(log):
        with pytest.raises(_Built):
            port_train.main(["--synthetic", "--tiny", "--subset-size", "16", "--no-save",
                             "--device", device, *flags])
    assert seen["dtype"] == want
    assert port_train.compute_dtype(not flags, torch.device(device)) == want
    name = "bfloat16" if want == BF16 else "float32"
    assert f"[Trainer] compute dtype {name} on {device}" in log.getvalue()
