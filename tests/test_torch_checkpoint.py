"""The port's checkpoints, Trainer, train CLI and engine loading, on the CPU.

The crash cases of ``tests/test_checkpoint.py`` replayed on the port's
files (``<name>.pt`` + ``<name>.meta.json``): a failure at any point of a
save leaves the previous checkpoint loadable. The sidecar keeps the JAX
package's schema, so ``vqa_tpu``'s ``load_checkpoint_meta`` reads it. The
Trainer's save/resume, best copy, final ``latest``, SIGTERM save and
scalar log follow the JAX Trainer's tests (``tests/test_training.py``);
resumed training takes the same step an uninterrupted run takes (loss
within 1e-5, dropout off, demo data, which is deterministic per index).

oneDNN's CPU convolution backward crashes in a process that has run
XLA:CPU programs (another test file may have, in the same worker), so it
is off for this module.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqa_tpu_torch.data.dataset import create_demo_loaders
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.training.train import Trainer
from vqa_tpu_torch.utils.config import ModelConfig, TrainingConfig, tiny_model_config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(vocab_size=64, num_answers=16)
TINY = dict(vocab_size=50, num_answers=8, embed_dim=16, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1, dropout=0.0, answer_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _payload(value: float):
    return {"model_state_dict": {"w": torch.full((4,), value)}}


def _save(tmp_path, value, epoch, name="latest"):
    ckpt_lib.save_checkpoint(str(tmp_path), name, _payload(value), CFG, {"epoch": epoch})


def _epoch_and_value(tmp_path, name="latest"):
    payload, _, meta = ckpt_lib.load_checkpoint(str(tmp_path), name)
    return meta["epoch"], float(payload["model_state_dict"]["w"][0])


# ---------------------------------------------------------------------------
# Crash safety
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_and_the_jax_sidecar_schema(tmp_path):
    _save(tmp_path, 1.0, 0)
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    assert _epoch_and_value(tmp_path) == (0, 1.0)
    _save(tmp_path, 2.0, 1)
    assert _epoch_and_value(tmp_path) == (1, 2.0)
    assert sorted(os.listdir(tmp_path)) == ["latest.meta.json", "latest.pt"]
    with open(tmp_path / "latest.meta.json") as f:
        sidecar = json.load(f)
    assert set(sidecar) == {"config", "meta"} and sidecar["config"]["vocab_size"] == 64
    from vqa_tpu.training.checkpoint import load_checkpoint_meta as jax_meta
    from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
    from vqa_tpu.utils.config import model_config_dict

    assert jax_meta(str(tmp_path), "latest") == {"epoch": 1}
    assert sidecar["config"] == model_config_dict(JaxModelConfig(vocab_size=64, num_answers=16))
    _, cfg, _ = ckpt_lib.load_checkpoint(str(tmp_path), "latest")
    assert cfg == CFG


def test_crash_during_the_write_keeps_previous(tmp_path, monkeypatch):
    _save(tmp_path, 1.0, 0)
    real_save = torch.save

    def exploding_save(obj, path, *a, **k):
        real_save(obj, path, *a, **k)  # partial artifacts exist on disk
        raise RuntimeError("simulated crash mid-save")

    monkeypatch.setattr(torch, "save", exploding_save)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _save(tmp_path, 2.0, 1)
    monkeypatch.undo()
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    assert _epoch_and_value(tmp_path) == (0, 1.0)
    assert not os.path.exists(tmp_path / "latest.tmp.pt")
    assert not os.path.exists(tmp_path / "latest.tmp.meta.json")


def test_crash_between_swap_renames_recovers(tmp_path):
    _save(tmp_path, 1.0, 0)
    stem = os.path.join(str(tmp_path), "latest")
    os.rename(stem + ".pt", stem + ".old.pt")
    os.rename(stem + ".meta.json", stem + ".old.meta.json")
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    assert _epoch_and_value(tmp_path) == (0, 1.0)


def test_crash_after_the_first_rename_recovers(tmp_path):
    """The data file moved to .old, its sidecar still in place."""
    _save(tmp_path, 1.0, 0)
    stem = os.path.join(str(tmp_path), "latest")
    os.rename(stem + ".pt", stem + ".old.pt")
    assert _epoch_and_value(tmp_path) == (0, 1.0)


def test_crash_during_best_copy_keeps_previous_best(tmp_path, monkeypatch):
    _save(tmp_path, 1.0, 0)
    ckpt_lib.save_best_copy(str(tmp_path))
    _save(tmp_path, 2.0, 1)
    import shutil

    def exploding_copy(src, dst, **kw):
        raise RuntimeError("simulated crash mid-copy")

    monkeypatch.setattr(shutil, "copyfile", exploding_copy)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ckpt_lib.save_best_copy(str(tmp_path))
    monkeypatch.undo()
    assert _epoch_and_value(tmp_path, "best_model") == (0, 1.0)
    ckpt_lib.save_best_copy(str(tmp_path))
    assert _epoch_and_value(tmp_path, "best_model") == (1, 2.0)


def test_crash_between_forward_renames_completes_swap(tmp_path):
    """The new data file landed, its sidecar still at .tmp.meta.json: the
    fully written new checkpoint is completed."""
    _save(tmp_path, 1.0, 0)
    _save(tmp_path, 2.0, 1)
    stem = os.path.join(str(tmp_path), "latest")
    os.rename(stem + ".meta.json", stem + ".tmp.meta.json")
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "latest")
    assert _epoch_and_value(tmp_path) == (1, 2.0)


# ---------------------------------------------------------------------------
# Trainer: save, resume, best, final latest, SIGTERM, scalars
# ---------------------------------------------------------------------------

def _loaders(num_samples=16):
    return create_demo_loaders(batch_size=4, eval_batch_size=4, num_samples=num_samples,
                               image_size=32, max_question_length=6, vocab_size=50,
                               num_answers=8)


def _trainer(tmp_path, seed=0, epochs=2, **kw):
    train_loader, val_loader = _loaders()
    model = create_vqa_model(config=ModelConfig(**TINY), device="cpu", seed=seed)
    cfg = TrainingConfig(num_epochs=epochs, batch_size=4, warmup_epochs=0,
                         learning_rate=1e-3, **kw)
    return Trainer(model, train_loader, val_loader, config=cfg,
                   checkpoint_dir=str(tmp_path), seed=3)


def test_resume_continues_as_an_uninterrupted_run(tmp_path):
    uninterrupted = _trainer(tmp_path / "a")
    first = uninterrupted.train_epoch(0)
    saved_step = uninterrupted.state.step
    uninterrupted.save("latest", 0)
    uninterrupted.train_loader.set_epoch(1)
    second = uninterrupted.train_epoch(1)

    resumed = _trainer(tmp_path / "a", seed=7)
    resumed.resume("latest")
    assert resumed.start_epoch == 1 and resumed.state.step == saved_step == 3
    resumed.train_loader.set_epoch(1)
    again = resumed.train_epoch(1)
    assert np.isfinite(first["train_loss"])
    assert abs(again["train_loss"] - second["train_loss"]) <= 1e-5
    for (k, a), b in zip(uninterrupted.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=k)


def test_train_writes_latest_best_and_history(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.best_val_accuracy = -1.0  # the first epoch improves
    logger = trainer.train()
    assert len(logger.history["train_loss"]) == 2 and "val_top1" in logger.history
    for name in ("latest", "best_model"):
        assert ckpt_lib.checkpoint_exists(str(tmp_path), name)
    meta = ckpt_lib.load_checkpoint_meta(str(tmp_path), "latest")
    assert meta["epoch"] == 1 and meta["metrics_history"]["epochs"] == [0, 1]
    payload, _, _ = ckpt_lib.load_checkpoint(str(tmp_path), "latest")
    assert payload["step"] == payload["scheduler_step"] == trainer.state.step == 6


def test_saves_latest_even_without_improvement(tmp_path, monkeypatch):
    ckpt_dir = tmp_path / "fresh" / "ckpts"  # does not exist yet
    trainer = _trainer(ckpt_dir, epochs=1)
    monkeypatch.setattr(trainer, "validate",
                        lambda: {"val_loss": 9.9, "val_top1": 0.0, "val_top5": 0.0})
    logger = trainer.train()
    assert os.path.exists(ckpt_dir / "latest.meta.json")
    assert not os.path.exists(ckpt_dir / "best_model.pt")
    logger.save(str(ckpt_dir / "sub" / "training_history.json"))
    assert os.path.exists(ckpt_dir / "sub" / "training_history.json")


def test_sigterm_saves_an_interrupted_checkpoint(tmp_path):
    trainer = _trainer(tmp_path, epochs=3)

    def validate_and_sigterm():
        os.kill(os.getpid(), signal.SIGTERM)
        return {"val_loss": 1.0, "val_top1": 0.0, "val_top5": 0.0}

    trainer.validate = validate_and_sigterm
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt):
        trainer.train()
    assert ckpt_lib.checkpoint_exists(str(tmp_path), "interrupted")
    assert signal.getsignal(signal.SIGTERM) == before


def test_model_only_checkpoint_resumes_with_a_fresh_optimizer(tmp_path):
    source = create_vqa_model(config=ModelConfig(**TINY), device="cpu", seed=5)
    ckpt_lib.save_checkpoint(str(tmp_path), "latest",
                             {"model_state_dict": source.state_dict()}, source.config,
                             {"epoch": 0, "best_val_accuracy": 0.0, "model_only": True,
                              "metrics_history": {"history": {}, "epochs": []}})
    trainer = _trainer(tmp_path)
    trainer.resume("latest")
    assert trainer.state.step == 0 and not trainer.state.optimizer.state
    for a, b in zip(source.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)


def test_scalar_log_and_jsonl_fallback(tmp_path, monkeypatch):
    import importlib

    from vqa_tpu_torch.utils.tb import ScalarWriter

    real_import_module = importlib.import_module

    def no_tb(name, *a, **k):
        if name.startswith(("tensorboardX", "torch.utils.tensorboard")):
            raise ImportError(name)
        return real_import_module(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", no_tb)
    w = ScalarWriter(str(tmp_path))
    assert w.backend == "jsonl"
    w.log_scalars(0, {"train_loss": 1.5})
    w.log_scalars(1, {"train_loss": 1.25})
    w.close()
    recs = [json.loads(line) for line in open(tmp_path / "scalars.jsonl")]
    assert recs == [{"step": 0, "tag": "train_loss", "value": 1.5},
                    {"step": 1, "tag": "train_loss", "value": 1.25}]

    train_loader, val_loader = _loaders(8)
    model = create_vqa_model(config=ModelConfig(**TINY), device="cpu")
    trainer = Trainer(model, train_loader, val_loader,
                      config=TrainingConfig(num_epochs=1, warmup_epochs=0, grad_accum=2),
                      save_checkpoints=False, log_dir=str(tmp_path / "tb"),
                      profile_dir=str(tmp_path / "trace"))
    trainer.train()
    tags = {json.loads(line)["tag"] for line in open(tmp_path / "tb" / "scalars.jsonl")}
    assert {"train_loss", "val_top1", "lr", "val_per_type/demo"} <= tags
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert trainer.step_timer.summary()["count"] == 1


def test_device_augmentation_path_trains_on_uint8_batches(tmp_path):
    from vqa_tpu_torch.data.synthetic import create_synthetic_loaders

    train_loader, val_loader, tok, vocab = create_synthetic_loaders(
        num_samples=20, batch_size=4, eval_batch_size=4, image_size=32,
        max_question_length=6, device_augment=True, seed=2)
    assert next(iter(train_loader))["image"].dtype == np.uint8
    model = create_vqa_model(config=ModelConfig(**{**TINY, "vocab_size": tok.vocab_size,
                                                   "num_answers": vocab.num_answers}),
                             device="cpu")
    trainer = Trainer(model, train_loader, val_loader,
                      config=TrainingConfig(num_epochs=1, warmup_epochs=0),
                      save_checkpoints=False)
    seen = []
    augment = trainer.augment
    trainer.augment = lambda px, e, s: seen.append(tuple(px.shape)) or augment(px, e, s)
    metrics = trainer.train_epoch(0)
    assert seen == [(4, 64, 64, 3)] * 4 and np.isfinite(metrics["train_loss"])
    a = trainer.augment(torch.zeros(2, 64, 64, 3, dtype=torch.uint8) + 100, 0, 1)
    b = trainer.augment(torch.zeros(2, 64, 64, 3, dtype=torch.uint8) + 100, 0, 1)
    assert torch.equal(a, b)  # seeded per (epoch, step)


# ---------------------------------------------------------------------------
# Engine and CLI
# ---------------------------------------------------------------------------

def test_engine_serves_a_port_checkpoint_with_its_geometry(tmp_path):
    """The tiny config's non-default CNN geometry comes back from the
    sidecar; probabilities equal the trained model's eval forward."""
    from vqa_tpu_torch.serving.engine import VQAInference

    trainer = _trainer(tmp_path, epochs=1)
    trainer.train()
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="latest",
                          device="cpu").load()
    assert engine.model_loaded_from_checkpoint and engine.model.config == trainer.model.config
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    questions = ["what is this", "how many are there", "is this a cat"]
    probs = engine.predict_probs_from_pixels(pixels, questions)
    from vqa_tpu_torch.data.preprocess import device_normalize

    ids, mask = engine.tokenizer.encode_batch_np(questions)
    with torch.inference_mode():
        logits, _ = trainer.model.eval()(device_normalize(torch.from_numpy(pixels)),
                                         torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(probs, torch.softmax(logits, -1).numpy(), atol=1e-6)


def _cli(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "vqa_tpu_torch.training.train", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_trains_validates_saves_resumes_and_the_engine_serves_it(tmp_path):
    from vqa_tpu_torch.serving.engine import VQAInference

    base = ("--synthetic", "--tiny", "--device", "cpu", "--subset-size", "96",
            "--batch-size", "8", "--checkpoint-dir", str(tmp_path))
    proc = _cli(*base, "--epochs", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[Trainer] epoch 0:" in proc.stdout
    for name in ("latest", "best_model"):
        assert os.path.exists(tmp_path / f"{name}.pt"), proc.stdout
        assert os.path.exists(tmp_path / f"{name}.meta.json")
    meta = ckpt_lib.load_checkpoint_meta(str(tmp_path), "latest")
    assert meta["synthetic"] == {"num_samples": 96, "seed": 42, "spatial": False}
    proc = _cli(*base, "--epochs", "2", "--resume", "latest", "--no-bf16")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Resumed from epoch 0" in proc.stdout and "[Trainer] epoch 1:" in proc.stdout
    history = json.load(open(tmp_path / "training_history.json"))
    assert history["epochs"] == [0, 1]

    engine = VQAInference(checkpoint_dir=str(tmp_path), device="cpu").load()
    assert engine.model_loaded_from_checkpoint
    assert engine.model.config.image_size == tiny_model_config().image_size
    out = engine.predict(np.zeros((64, 64, 3), np.uint8), "what color is the circle")
    assert out["top_answer"] in engine.answer_vocab.answer2idx


def test_cli_refuses_to_train_without_a_gpu():
    proc = _cli("--synthetic", "--tiny", "--epochs", "1", "--no-save", timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "[Trainer] epoch" not in proc.stdout
