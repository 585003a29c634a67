"""Resuming the port's trainer from the JAX trainer's Orbax checkpoint
(``compat/orbax.py:training_state``, ``compat/jax_weights.py:
adamw_state_from_jax``, ``training/checkpoint.py:load_training_checkpoint``,
``Trainer.resume``, the train CLI's ``--resume``), held against the JAX
package on the CPU.

From the committed fixture ``tests/fixtures/orbax_narrow/best_model`` (the
JAX trainer's tree after two AdamW steps, ``TrainingConfig(warmup_epochs=0)``
at two steps per epoch):

- moments: every ``exp_avg``/``exp_avg_sq`` equal (0) to the tree's ``mu``/
  ``nu`` as the JAX exporter maps a weight; step, rate, epoch, best
  accuracy and history equal to what the JAX trainer restores;
- three steps from the resumed state against the JAX trainer resumed with
  ``load_checkpoint`` and a target (dropout off, default torch threads):
  losses within 1e-5, parameters 2e-5, BN statistics 1e-5; the committed
  ``resumed.npz`` (``make_fixture.py --resumed``) equal to that JAX run;
- the first resumed step takes ``schedule(step)``, not ``schedule(0)``;
- a ``model_only`` tree, an mp2 grid, what raises, a save that replaces
  the JAX tree under its name (and the crash recovery of that swap),
  ``chip_smoke.py`` phase 18 (b)'s tree writer, and the train CLI.

oneDNN's CPU convolution backward crashes in a process that has run XLA:CPU
programs, so it is off for this module.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.compat.torch_export import flax_to_torch_state_dict
from vqa_tpu.models import create_vqa_model as jax_create_model
from vqa_tpu.models import init_vqa_model
from vqa_tpu.training import checkpoint as jax_ckpt
from vqa_tpu.training import train as jax_train
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import TrainingConfig as JaxTrainingConfig
from vqa_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from vqa_tpu_torch.compat import orbax
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.training import train as port_train
from vqa_tpu_torch.utils.config import TrainingConfig, model_config_dict, tiny_model_config
from test_torch_ranks import resumed_moments, run_ranks
from test_torch_threads import default_torch_threads, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_narrow")
RESUMED = np.load(os.path.join(FIXTURE, "resumed.npz"))
SPE = 2  # the fixture's steps per epoch
sys.path.insert(0, FIXTURE)
import inputs  # noqa: E402  (tests/fixtures/orbax_narrow/inputs.py, numpy only)


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _config(dropout: bool = False):
    _, cfg, _ = ckpt_lib.load_orbax_checkpoint(FIXTURE, "best_model")
    return cfg if dropout else dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)


def _trainer(base=FIXTURE, cfg=None, config=None, save=False, **model_kw):
    """A CPU Trainer over the fixture's model (other seeded weights), its
    loaders of the fixture's length, checkpointing into ``base``."""
    model = create_vqa_model(config=cfg or _config(), device="cpu", seed=5, **model_kw)
    return port_train.Trainer(model, [None] * SPE, [], config=config or TrainingConfig(
        warmup_epochs=0), checkpoint_dir=str(base), save_checkpoints=save)


def _copy_fixture(base, name="best_model"):
    shutil.copytree(os.path.join(FIXTURE, "best_model"), os.path.join(base, name))
    shutil.copyfile(os.path.join(FIXTURE, "best_model.meta.json"),
                    os.path.join(base, name + ".meta.json"))


def _batches():
    images = inputs.images(4).astype(np.float32) / 255.0 - 0.5
    return [(images, RESUMED["ids"][i], RESUMED["mask"][i], RESUMED["labels"][i])
            for i in range(len(RESUMED["losses"]))]


def _restored_jax_tree():
    """The fixture's tree as the JAX package restores it without a target
    (optax's states as lists), numpy leaves."""
    tree, _, _ = jax_ckpt.load_checkpoint(FIXTURE, "best_model")
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The moments, counts, rate and sidecar
# ---------------------------------------------------------------------------

def test_moments_step_rate_and_sidecar_equal_the_jax_trainers():
    trainer = _trainer()
    trainer.resume("best_model")
    tree = _restored_jax_tree()
    adam = tree["opt_state"][1][0]
    cfg = _config()
    want = {k: flax_to_torch_state_dict({"params": adam[m]}, cfg)
            for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
    opt = trainer.state.optimizer
    checked = 0
    for name, p in trainer.model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 2.0, name
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].shape == p.shape and st[k].dtype == torch.float32, name
            np.testing.assert_array_equal(st[k].numpy(), want[k][name], err_msg=name)
            checked += 1
    assert checked == 2 * len(list(trainer.model.parameters())) > 0
    assert trainer.state.step == int(tree["step"]) == 2
    _, jax_schedule = jax_train.make_optimizer(JaxTrainingConfig(warmup_epochs=0), SPE)
    lr = opt.param_groups[0]["lr"]
    assert lr == trainer.schedule(2) != trainer.schedule(0)
    assert abs(lr - float(jax_schedule(2))) <= 1e-6 * 1e-4
    meta = ckpt_lib.load_checkpoint_meta(FIXTURE, "best_model")
    assert trainer.start_epoch == 2 and trainer.best_val_accuracy == 0.25
    assert trainer.logger.to_dict() == \
        JaxMetricsLogger.from_dict(meta["metrics_history"]).to_dict()


# ---------------------------------------------------------------------------
# Three steps from the resumed state against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_resumed():
    """The JAX trainer resumed from the fixture (``load_checkpoint`` with a
    target tree), dropout off, then three steps on ``resumed.npz``'s
    batches: (losses, params, batch_stats)."""
    cfg = JaxModelConfig(**model_config_dict(_config()))
    model = jax_create_model(config=cfg)
    shapes = jax.eval_shape(lambda: init_vqa_model(model, jax.random.PRNGKey(0)))
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(warmup_epochs=0), SPE)
    target = {"params": shapes["params"], "batch_stats": shapes["batch_stats"],
              "opt_state": jax.eval_shape(tx.init, shapes["params"]),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    tree, _, _ = jax_ckpt.load_checkpoint(FIXTURE, "best_model", target)
    state = jax_train.TrainState.create(apply_fn=model.apply, params=tree["params"], tx=tx,
                                        batch_stats=tree["batch_stats"])
    state = state.replace(opt_state=tree["opt_state"], step=tree["step"])
    step = jax_train.make_train_step(model)
    losses = []
    for i, batch in enumerate(_batches()):
        state, m = step(state, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(10 + i))
        losses.append(float(m["loss"]))
    assert int(state.step) == 5
    return (losses, jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_three_resumed_steps_follow_jax(jax_resumed, default_torch_threads):  # noqa: F811
    losses, params, batch_stats = jax_resumed
    trainer = _trainer()
    trainer.resume("best_model")
    for i, batch in enumerate(_batches()):
        m = trainer.train_step(trainer.state, *(torch.from_numpy(a) for a in batch))
        assert abs(float(m["loss"]) - losses[i]) <= 1e-5, i
    assert trainer.state.step == 5
    want = state_dict_from_jax({"params": params, "batch_stats": batch_stats}, _config())
    got = trainer.model.state_dict()
    for key, value in want.items():
        if key.endswith(("num_batches_tracked", ".pe")):
            continue
        atol = 1e-5 if key.endswith(("running_mean", "running_var")) else 2e-5
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=0, atol=atol,
                                   err_msg=key)


def test_the_committed_resumed_steps_are_the_jax_trainers(jax_resumed):
    """``resumed.npz`` (phase 18 (a)'s reference on the card) holds what the
    JAX trainer computes now."""
    losses, params, batch_stats = jax_resumed
    np.testing.assert_allclose(RESUMED["losses"], losses, rtol=0, atol=1e-6)
    flat = {".".join(("params",) + p): a for p, a in _flat_items(params)}
    flat.update({".".join(("batch_stats",) + p): a for p, a in _flat_items(batch_stats)})
    stored = {k for k in RESUMED.files if k.startswith(("params.", "batch_stats."))}
    assert stored == set(flat) and int(RESUMED["step"]) == 5
    for key, value in flat.items():
        np.testing.assert_allclose(RESUMED[key], value, rtol=0, atol=1e-6, err_msg=key)


def _flat_items(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, path + (k,))
        else:
            yield path + (k,), v


def test_the_first_resumed_step_takes_the_resumed_rate():
    """With a warmup of 2 epochs (4 steps) schedule(0) is 0 and schedule(2)
    half the peak: the resumed step moves each weight by exactly AdamW's
    update at schedule(2)."""
    trainer = _trainer(config=TrainingConfig(warmup_epochs=2, num_epochs=30))
    trainer.resume("best_model")
    rate = trainer.schedule(2)
    assert trainer.schedule(0) == 0.0 and trainer.state.optimizer.param_groups[0]["lr"] == rate
    before = {n: p.detach().clone().double() for n, p in trainer.model.named_parameters()}
    trainer.train_step(trainer.state, *(torch.from_numpy(a) for a in _batches()[0]))
    opt, cfg = trainer.state.optimizer, trainer.cfg
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    largest = 0.0
    for name, p in trainer.model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 3.0
        m = st["exp_avg"].double() / (1 - b1 ** 3)
        v = st["exp_avg_sq"].double() / (1 - b2 ** 3)
        update = (rate * (m / (v.sqrt() + 1e-8) + cfg.weight_decay * before[name])).numpy()
        after = p.detach().numpy()
        moved = before[name].numpy() - after
        # the new weight is rounded to f32: two of its ulps beside 1e-4 of the update
        tol = 1e-4 * np.abs(update) + 2 * np.spacing(np.abs(after))
        assert (np.abs(moved - update) <= tol).all(), name
        largest = max(largest, float(np.abs(moved).max()))
    assert largest > 0.1 * rate


# ---------------------------------------------------------------------------
# model_only, the grid, what raises
# ---------------------------------------------------------------------------

def _save_jax_tree(base, name, tree, meta_update=None):
    meta = ckpt_lib.load_checkpoint_meta(FIXTURE, "best_model")
    jax_ckpt.save_checkpoint(str(base), name, tree, JaxModelConfig(**model_config_dict(
        _config(dropout=True))), {**meta, **(meta_update or {})})


def test_a_model_only_tree_loads_the_weights_and_keeps_a_fresh_optimizer(tmp_path):
    tree = _restored_jax_tree()
    _save_jax_tree(tmp_path, "latest", {"params": tree["params"],
                                        "batch_stats": tree["batch_stats"]},
                   {"model_only": True})
    trainer = _trainer(tmp_path)
    trainer.resume("latest")
    want = state_dict_from_jax(tree, _config())
    for key, value in trainer.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, want[key]), key
    assert trainer.state.step == 0 and not trainer.state.optimizer.state
    assert trainer.state.optimizer.param_groups[0]["lr"] == trainer.schedule(0)
    assert trainer.start_epoch == 2


def test_each_rank_of_an_mp2_grid_resumes_its_slices_of_the_moments():
    single = _trainer()
    single.resume("best_model")
    opt = single.state.optimizer
    full = {n: {k: opt.state[p][k].numpy() for k in ("exp_avg", "exp_avg_sq")}
            for n, p in single.model.named_parameters()}
    ranks = run_ranks(resumed_moments, 2, FIXTURE, "best_model", timeout=120)
    assert ranks[0]["splits"] and ranks[0]["splits"] == ranks[1]["splits"]
    for out in ranks:
        assert out["step"] == 2 and out["moments"].keys() == full.keys()
        for name, moments in out["moments"].items():
            dim = out["splits"].get(name)
            for k, got in moments.items():
                want = full[name][k] if dim is None else \
                    np.split(full[name][k], 2, axis=dim)[out["model_index"]]
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {k}")


def _chain_of_adam_alone(tree):
    tree["opt_state"] = tree["opt_state"][1]  # optax.adamw without the clip


def _no_opt_state(tree):
    del tree["opt_state"]


def _counts_disagree(tree):
    tree["opt_state"][1][2]["count"] = np.asarray(3, np.int32)


@pytest.mark.parametrize("change,error,match", [
    (_chain_of_adam_alone, orbax.OrbaxError,
     r"opt_state is \[\{count, mu, nu\}, None, \{count\}\], not the JAX trainer's"),
    (_no_opt_state, orbax.OrbaxError, "no opt_state, and its sidecar is not flagged model_only"),
    (_counts_disagree, ValueError,
     r"Adam's count \[2\], the schedule's count 3 and step 2 disagree"),
], ids=["another_chain", "no_opt_state", "counts_disagree"])
def test_a_tree_that_does_not_map_raises(tmp_path, change, error, match):
    tree = _restored_jax_tree()
    change(tree)
    _save_jax_tree(tmp_path, "latest", tree)
    trainer = _trainer(tmp_path)
    with pytest.raises(error, match=match):
        trainer.resume("latest")
    assert trainer.state.step == 0 and not trainer.state.optimizer.state


def test_a_model_without_the_trees_parameters_raises():
    trainer = _trainer(use_attention=False)
    with pytest.raises(KeyError, match=r"only in the model \[\], only in the tree "
                                       r"\['image_encoder.stage1.attention.se.fc1.weight'"):
        trainer.resume("best_model")
    assert trainer.state.step == 0 and not trainer.state.optimizer.state


# ---------------------------------------------------------------------------
# A name holds one checkpoint
# ---------------------------------------------------------------------------

def _sidecar(base, name):
    with open(os.path.join(base, name + ".meta.json"), encoding="utf-8") as f:
        return json.load(f)["meta"]


@pytest.mark.parametrize("how", ["save_checkpoint", "trainer_save_and_best_copy"])
def test_a_save_replaces_the_jax_tree_of_its_name(tmp_path, how):
    """The port's save of a name whose data is a JAX tree leaves one
    checkpoint under it: ``<name>.pt`` with its sidecar, the tree gone."""
    _copy_fixture(tmp_path, "latest")
    _copy_fixture(tmp_path, "best_model")
    trainer = _trainer(tmp_path, save=True)
    if how == "save_checkpoint":
        ckpt_lib.save_checkpoint(str(tmp_path), "latest",
                                 {"model_state_dict": trainer.model.state_dict()},
                                 trainer.model.config, {"epoch": 7, "best_val_accuracy": 0.5,
                                                        "metrics_history": {}})
        names = ["latest"]
    else:
        trainer.resume("latest")
        trainer.save("latest", 4)
        ckpt_lib.save_best_copy(str(tmp_path))
        names = ["latest", "best_model"]
    for name in names:
        assert not (tmp_path / name).exists() and (tmp_path / f"{name}.pt").is_file(), name
        assert not any(p.name.startswith(f"{name}.old") or ".tmp" in p.name
                       for p in tmp_path.iterdir()), sorted(os.listdir(tmp_path))
        assert _sidecar(tmp_path, name)["epoch"] == (7 if how == "save_checkpoint" else 4)
    if how != "save_checkpoint":
        payload, _, _ = ckpt_lib.load_checkpoint(str(tmp_path), "best_model")
        assert payload["step"] == 2
        again = _trainer(tmp_path)
        again.resume("best_model")
        assert again.state.step == 2 and again.start_epoch == 5


def test_a_crash_inside_the_swap_of_a_jax_tree_recovers(tmp_path):
    """The tree parked at ``<name>.old/`` with its sidecar and nothing in its
    place comes back; a new ``.pt`` that landed without its sidecar gets
    it, and the parked tree does not come back beside it."""
    _copy_fixture(tmp_path, "latest.old")
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    assert (tmp_path / "latest").is_dir() and not (tmp_path / "latest.old").exists()
    trainer = _trainer(tmp_path)
    trainer.resume("latest")
    assert trainer.state.step == 2

    os.rename(tmp_path / "latest", tmp_path / "latest.old")
    os.rename(tmp_path / "latest.meta.json", tmp_path / "latest.old.meta.json")
    torch.save(trainer._payload(), tmp_path / "latest.pt")
    with open(tmp_path / "latest.tmp.meta.json", "w", encoding="utf-8") as f:
        json.dump({"config": model_config_dict(trainer.model.config),
                   "meta": {"epoch": 6, "best_val_accuracy": 0.5, "metrics_history": {}}}, f)
    assert ckpt_lib.load_checkpoint_meta(str(tmp_path), "latest")["epoch"] == 6
    assert not (tmp_path / "latest").exists()
    again = _trainer(tmp_path)
    again.resume("latest")
    assert again.start_epoch == 7 and again.state.step == 2


# ---------------------------------------------------------------------------
# chip_smoke.py phase 18 (b)'s writer
# ---------------------------------------------------------------------------

def _leaf_specs(tree, path=()):
    """{key path: (shape, dtype) or None} of every leaf."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in _leaf_specs(sub, path + (str(key),)).items()}
    return {path: None if tree is None else (np.shape(tree), np.asarray(tree).dtype.str)}


def test_the_phase_18_writer_writes_the_jax_trainers_tree(tmp_path):
    """``vqa_tpu_torch.testing.write_trainer_tree`` at a narrow config:
    read by the port's reader, the JAX-written tree's names, shapes and
    dtypes; a Trainer resumes from it, its moments the ones written."""
    from vqa_tpu_torch.testing import mapped_moments, write_trainer_tree

    cfg = dataclasses.replace(tiny_model_config(), image_size=32)
    model = create_vqa_model(config=cfg, device="cpu", seed=3)
    meta = {"epoch": 3, "best_val_accuracy": 0.5, "metrics_history": {}}
    write_trainer_tree(str(tmp_path / "port"), "latest", model, np.random.default_rng(0), 250,
                       meta)
    jcfg = JaxModelConfig(**model_config_dict(cfg))
    shapes = jax.eval_shape(lambda: init_vqa_model(jax_create_model(config=jcfg),
                                                   jax.random.PRNGKey(0)))
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(), 100)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), {
        **shapes, "opt_state": jax.eval_shape(tx.init, shapes["params"])})
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "latest", {
        **zeros, "step": np.asarray(250, np.int32)}, jcfg, meta)
    ours, _, _ = ckpt_lib.load_orbax_checkpoint(str(tmp_path / "port"), "latest")
    theirs, _, _ = ckpt_lib.load_orbax_checkpoint(str(tmp_path / "jax"), "latest")
    assert _leaf_specs(ours) == _leaf_specs(theirs)
    assert orbax.layout(ours["opt_state"]) == orbax.TRAINER_CHAIN
    trainer = port_train.Trainer(create_vqa_model(config=cfg, device="cpu", seed=4), [None] * 100,
                                 [], checkpoint_dir=str(tmp_path / "port"),
                                 save_checkpoints=False)
    trainer.resume("latest")
    for (name, p), (_, q) in zip(trainer.model.named_parameters(), model.named_parameters()):
        assert torch.equal(p, q), name
    want = mapped_moments(str(tmp_path / "port"), "latest",
                          [n for n, _ in model.named_parameters()])
    opt = trainer.state.optimizer
    for i, p in enumerate(trainer.model.parameters()):
        assert torch.equal(opt.state[p]["exp_avg"], want[i]["exp_avg"])
        assert torch.equal(opt.state[p]["exp_avg_sq"], want[i]["exp_avg_sq"])
        assert (opt.state[p]["exp_avg_sq"] >= opt.state[p]["exp_avg"] ** 2).all()
    assert trainer.state.step == 250 and trainer.start_epoch == 4


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------

def test_the_train_cli_resumes_a_jax_tree(tmp_path):
    """``--resume latest`` on a JAX tree in ``--checkpoint-dir`` at the tiny
    size: the run goes on from the tree's epoch, step and history, and its
    save replaces the tree by ``latest.pt``."""
    from vqa_tpu_torch.data.dataset import create_demo_loaders

    cfg = tiny_model_config()
    jcfg = JaxModelConfig(**model_config_dict(cfg))
    shapes = jax.eval_shape(lambda: init_vqa_model(jax_create_model(config=jcfg),
                                                   jax.random.PRNGKey(0)))
    tx, _ = jax_train.make_optimizer(JaxTrainingConfig(), 6)
    rng = np.random.default_rng(1)

    def fill(path, s):
        names = {getattr(k, "key", getattr(k, "name", None)) for k in path}
        if s.dtype == jnp.int32:
            return np.full(s.shape, 4, s.dtype)
        if "var" in names:
            return np.ones(s.shape, s.dtype)
        scale = 1e-3 if "mu" in names or "nu" in names else 0.05
        x = (scale * rng.standard_normal(s.shape)).astype(s.dtype)
        return x * x if "nu" in names else x

    tree = jax.tree_util.tree_map_with_path(fill, {
        **shapes, "opt_state": jax.eval_shape(tx.init, shapes["params"])})
    history = {"history": {"train_loss": [2.75], "val_top1": [0.125]}, "epochs": [0]}
    jax_ckpt.save_checkpoint(str(tmp_path), "latest", {**tree, "step": np.asarray(4, np.int32)},
                             jcfg, {"epoch": 0, "best_val_accuracy": 0.125,
                                    "metrics_history": history})
    logger = port_train.main(["--demo", "--tiny", "--device", "cpu", "--epochs", "2",
                              "--checkpoint-dir", str(tmp_path), "--resume", "latest"])
    train_loader, _ = create_demo_loaders(batch_size=32, num_samples=256,
                                          image_size=cfg.image_size,
                                          max_question_length=cfg.max_question_length,
                                          vocab_size=cfg.vocab_size,
                                          num_answers=cfg.num_answers)
    assert logger.epochs == [0, 1] and logger.history["train_loss"][0] == 2.75
    assert not (tmp_path / "latest").exists()
    payload, _, meta = ckpt_lib.load_checkpoint(str(tmp_path), "latest")
    assert payload["step"] == 4 + len(train_loader) and meta["epoch"] == 1
    assert meta["metrics_history"]["epochs"] == [0, 1]
