"""The port's evaluator (``vqa_tpu_torch.training.evaluate``) against the
JAX package's, on the CPU.

Both evaluate the same tiny weights (the JAX model's variables carried into
the port) on the same loaders: demo data, and a ``VQADataset`` with
annotator answers and question types (``tests/fixtures/mini_vqa``). In f32
the sample count and the top-1, top-5, per-type and VQA-soft counts are
equal, the loss and per-class accuracies within 1e-6, the error pairs and
the sample predictions' top-5 indices equal, their probabilities within
1e-5; a row whose logits are within 1e-3 of a tie may take the other
answer, and each such row may move a count by one. In bf16 (``--bf16``)
the logits are held to the JAX evaluator's in bf16 by 2x the JAX model's
own bf16 noise (its bf16 logits against its f32 ones), and the argmax to
JAX's on every row whose top-2 margin exceeds that bound.

Then the sample cache (it answers only the loader it was filled from), and
the port-only CLI round trip: ``train --synthetic --tiny`` then
``evaluate --synthetic`` (split size, the reference key aliases, the
``latest`` fallback, ``--max-samples``, ``--bf16``, the mesh flags and the
no-GPU exit).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_tpu.data import dataset as jax_dataset
from vqa_tpu.models import create_vqa_model as jax_create_vqa_model
from vqa_tpu.models import init_vqa_model
from vqa_tpu.training.evaluate import Evaluator as JaxEvaluator
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.data import dataset
from vqa_tpu_torch.models import create_vqa_model
from vqa_tpu_torch.training import evaluate
from vqa_tpu_torch.training.evaluate import Evaluator
from vqa_tpu_torch.utils.config import model_config_from_dict

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "mini_vqa")
TINY = dict(embed_dim=16, num_transformer_layers=1, num_attention_heads=2, ffn_hidden_dim=32,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1)
TIE = 1e-3  # rows within this of a tie may take either answer


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    # the CLI round trip trains: torch's oneDNN CPU conv backward fails in a
    # process that has run an XLA:CPU program
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _models(vocab_size, num_answers, max_question_length, seed=0):
    """(JAX model, its variables, the port's model with the same weights)."""
    jcfg = JaxModelConfig(vocab_size=vocab_size, num_answers=num_answers,
                          max_question_length=max_question_length, **TINY)
    jmodel = jax_create_vqa_model(config=jcfg)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(seed))
    cfg = model_config_from_dict(model_config_dict(jcfg))
    model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return jmodel, variables, model


def _margins(logits, k):
    """Per row: the k-th largest logit minus the (k+1)-th."""
    s = -np.sort(-np.asarray(logits, np.float64), axis=-1)
    return s[:, k - 1] - s[:, k]


def _all_logits(ev):
    return np.asarray(ev._sample_cache["logits"], np.float32)


def _assert_same_results(got, want, jax_logits, n):
    """The f32 rule of the module docstring; ``jax_logits`` are every
    evaluated row's, in order."""
    assert got["num_samples"] == want["num_samples"] == n
    slack1 = int((_margins(jax_logits, 1) <= TIE).sum())
    slack5 = int((_margins(jax_logits, 5) <= TIE).sum())
    assert abs(round(got["top1_accuracy"] * n) - round(want["top1_accuracy"] * n)) <= slack1
    assert abs(round(got["top5_accuracy"] * n) - round(want["top5_accuracy"] * n)) <= slack5
    assert got["per_type_accuracy"].keys() == want["per_type_accuracy"].keys()
    for qt, acc in want["per_type_accuracy"].items():
        assert abs(got["per_type_accuracy"][qt] - acc) * n <= slack1 + 1e-9
    assert ("vqa_soft_accuracy" in got) == ("vqa_soft_accuracy" in want)
    if "vqa_soft_accuracy" in want:
        assert abs(got["vqa_soft_accuracy"] - want["vqa_soft_accuracy"]) * n <= slack1 + 1e-9
    assert abs(got["loss"] - want["loss"]) <= 1e-6
    assert len(got["per_class_accuracy_top"]) == len(want["per_class_accuracy_top"])
    if slack1 == 0:
        np.testing.assert_allclose(got["per_class_accuracy_top"],
                                   want["per_class_accuracy_top"], atol=1e-6, rtol=0)
        assert got["error_pairs"] == want["error_pairs"]


def _assert_same_samples(got, want, jax_logits):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert {k: v for k, v in g.items() if not k.startswith("top5")} == \
            {k: v for k, v in w.items() if not k.startswith("top5")}
        np.testing.assert_allclose(g["top5_probs"], w["top5_probs"], atol=1e-5, rtol=0)
        s = -np.sort(-jax_logits[i])
        if np.all(s[:5] - s[1:6] > TIE):  # no two of the first six in a near tie
            assert g["top5_indices"] == w["top5_indices"]
            assert g.get("top5_answers") == w.get("top5_answers")


def _demo_loaders(n=40, batch=16, num_answers=8, L=6, vocab=50):
    kw = dict(num_samples=n, image_size=TINY["image_size"], max_question_length=L,
              vocab_size=vocab, num_answers=num_answers)
    return (dataset.BatchLoader(dataset.DemoVQADataset(**kw), batch, drop_last=False),
            jax_dataset.BatchLoader(jax_dataset.DemoVQADataset(**kw), batch, drop_last=False))


@pytest.fixture(scope="module")
def demo():
    jmodel, variables, model = _models(50, 8, 6)
    loader, jloader = _demo_loaders()
    ev, jev = Evaluator(model), JaxEvaluator(jmodel, variables)
    got, want = ev.evaluate(loader, sample_cache=40), jev.evaluate(jloader, sample_cache=40)
    return dict(jmodel=jmodel, variables=variables, model=model, loader=loader,
                jloader=jloader, ev=ev, jev=jev, got=got, want=want)


def test_evaluator_matches_jax_on_demo_data(demo):
    jl = _all_logits(demo["jev"])
    np.testing.assert_allclose(_all_logits(demo["ev"]), jl, atol=1e-4, rtol=0)
    _assert_same_results(demo["got"], demo["want"], jl, 40)
    assert demo["got"]["per_type_accuracy"].keys() == {"demo"}
    _assert_same_samples(demo["ev"].sample_predictions(demo["loader"], None, num=20),
                         demo["jev"].sample_predictions(demo["jloader"], None, num=20), jl)
    assert demo["ev"].generate_report(demo["got"]).splitlines()[:4] == \
        demo["jev"].generate_report(demo["want"]).splitlines()[:4]


def test_evaluator_matches_jax_on_vqa_data_with_annotators():
    paths = [os.path.join(FIXTURE, f) for f in ("questions.json", "annotations.json", "images")]
    kw = dict(batch_size=8, eval_batch_size=8, max_samples=60, max_question_length=8,
              vocab_size=100, num_answers=12, image_size=TINY["image_size"], seed=4)
    _, loader, tok, vocab = dataset.create_train_val_loaders(*paths, **kw)
    _, jloader, jtok, jvocab = jax_dataset.create_train_val_loaders(*paths, **kw)
    jmodel, variables, model = _models(tok.vocab_size, vocab.num_answers, 8, seed=3)
    ev, jev = Evaluator(model, vocab), JaxEvaluator(jmodel, variables, jvocab)
    n = len(loader.indices)
    got, want = ev.evaluate(loader, sample_cache=n), jev.evaluate(jloader, sample_cache=n)
    assert "vqa_soft_accuracy" in got and len(got["per_type_accuracy"]) > 1
    jl = _all_logits(jev)
    _assert_same_results(got, want, jl, n)
    assert all("predicted_answer" in e for e in got["error_pairs"])
    _assert_same_samples(ev.sample_predictions(loader, tok, num=10),
                         jev.sample_predictions(jloader, jtok, num=10), jl)


def test_bf16_evaluator_matches_jax_bf16_within_its_own_noise(demo):
    """The self-calibrated rule: the JAX model's own bf16 noise on these
    inputs bounds the port's distance from JAX's bf16 logits."""
    loader, jloader = _demo_loaders()
    jev16 = JaxEvaluator(jax_create_vqa_model(config=demo["jmodel"].config,
                                              dtype=jnp.bfloat16), demo["variables"])
    model16 = create_vqa_model(config=demo["model"].config, device="cpu",
                               dtype=torch.bfloat16)
    model16.load_state_dict(demo["model"].state_dict(), strict=True)
    ev16 = Evaluator(model16)
    got, want = ev16.evaluate(loader, sample_cache=40), jev16.evaluate(jloader, sample_cache=40)
    j32, j16, p16 = _all_logits(demo["jev"]), _all_logits(jev16), _all_logits(ev16)
    noise = float(np.abs(j16 - j32).max())
    assert noise > 0  # the JAX model did compute in bf16
    bound = 2 * noise
    assert float(np.abs(p16 - j16).max()) <= bound
    clear = _margins(j16, 1) > bound
    assert (p16.argmax(-1) == j16.argmax(-1))[clear].all()
    assert got["num_samples"] == want["num_samples"] == 40


def test_sample_cache_answers_only_its_own_loader(demo, monkeypatch):
    """A loader the cache was not filled from, or more samples than an
    incomplete cache holds, runs forwards; the cache's own loader does not."""
    ev = Evaluator(demo["model"])
    loader, _ = _demo_loaders()
    other, _ = _demo_loaders(n=24, batch=8)
    ev.evaluate(loader, sample_cache=8)
    calls = []
    step = ev.eval_step
    monkeypatch.setattr(ev, "eval_step", lambda *a: calls.append(1) or step(*a))
    cached = ev.sample_predictions(loader, None, num=8)
    assert not calls and len(cached) == 8
    fresh = Evaluator(demo["model"]).sample_predictions(other, None, num=5)
    assert ev.sample_predictions(other, None, num=5) == fresh and calls
    calls.clear()
    more = ev.sample_predictions(loader, None, num=20)  # 20 > 8 cached of 40
    assert calls and len(more) == 20 and more[:8] == cached


def _train_tiny(tmp, subset=100):
    from vqa_tpu_torch.training import train

    train.main(["--synthetic", "--tiny", "--device", "cpu", "--epochs", "1",
                "--subset-size", str(subset), "--checkpoint-dir", str(tmp)])


def test_cli_round_trip_after_train(tmp_path, capsys):
    _train_tiny(tmp_path)
    out = tmp_path / "eval"
    res = evaluate.main(["--checkpoint-dir", str(tmp_path), "--synthetic", "--device", "cpu",
                         "--output-dir", str(out)])
    assert res["num_samples"] == 100 - int(100 * 0.8)  # the training run's val split
    # the trainer's own validation of these weights on the same split
    history = json.loads((tmp_path / "training_history.json").read_text())
    assert abs(res["top1_accuracy"] - history["history"]["val_top1"][-1]) <= 1e-9
    art = json.loads((out / "evaluation_results.json").read_text())
    assert art["accuracy"] == art["top1_accuracy"] and art["accuracy_top5"] == art["top5_accuracy"]
    assert art["total_samples"] == 20 and art["correct"] == round(art["accuracy"] * 20)
    assert art["per_class_accuracy"] == art["per_class_accuracy_top"]
    assert [(e["predicted_idx"], e["target_idx"], e["count"]) for e in art["common_errors"]] == \
        [(e["predicted"], e["target"], e["count"]) for e in art["error_pairs"]]
    assert all(isinstance(e["predicted"], str) for e in art["common_errors"])
    assert len(art["sample_predictions"]) == 20
    assert (out / "evaluation_report.txt").read_text().startswith("=" * 60)

    # --max-samples caps the rebuilt split; --bf16 computes in bf16
    res16 = evaluate.main(["--checkpoint-dir", str(tmp_path), "--synthetic", "--device", "cpu",
                           "--output-dir", str(out), "--max-samples", "7", "--bf16"])
    assert res16["num_samples"] == 7
    assert "caps the val split to 7 of 20" in capsys.readouterr().out

    # no best_model: the evaluator falls back to latest
    for suffix in (".pt", ".meta.json"):
        os.remove(tmp_path / f"best_model{suffix}")
    res = evaluate.main(["--checkpoint-dir", str(tmp_path), "--synthetic", "--device", "cpu",
                         "--output-dir", str(out)])
    assert "falling back to 'latest'" in capsys.readouterr().out
    assert res["num_samples"] == 20


def test_cli_stops_on_mesh_flags_and_without_a_card():
    """In one process a grid of two ranks stops with the mesh's named
    error, which names the launcher."""
    with pytest.raises(ValueError, match=r"mesh 2×1 needs 2 processes .* torchrun "
                                         r"--nproc-per-node 2"):
        evaluate.main(["--checkpoint-dir", "nowhere", "--data-parallel", "2"])
    with pytest.raises(ValueError, match=r"model_parallel=2 does not divide 1 processes"):
        evaluate.main(["--checkpoint-dir", "nowhere", "--model-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--checkpoint-dir", "nowhere", "--demo"])


def test_demo_cli_and_partial_paths_fall_back_to_demo(tmp_path, capsys):
    _train_tiny(tmp_path, subset=40)
    res = evaluate.main(["--checkpoint-dir", str(tmp_path), "--device", "cpu",
                         "--questions", str(tmp_path / "missing.json"), "--max-samples", "9"])
    assert "demo data" in capsys.readouterr().out
    assert res["num_samples"] == 9 and res["per_type_accuracy"].keys() == {"demo"}
