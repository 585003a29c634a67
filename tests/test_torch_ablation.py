"""The port's ablation runner (``vqa_tpu_torch/tools/run_ablation.py``), on
the CPU, with training and evaluation stubbed out: no model runs.

The counterpart of ``tests/test_ablation_writer.py``: the table keeps every
variant with cells, reads the old single-seed schema, computes the JAX
script's Student-t half-width, and reruns no cell that ``--out`` holds.
Beside it: ``mean_ci95`` equals the JAX script's (loaded by path, as its
own test loads it; the port never imports it), the subprocesses are the
port's modules, and without ``--out`` no table is written.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from vqa_tpu_torch.tools import run_ablation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "jax_run_ablation", os.path.join(REPO, "scripts", "run_ablation.py"))
jax_run_ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_run_ablation)


def _cell(top1, wall=100.0):
    return {
        "train_wall_s": wall,
        "heldout_top1": top1,
        "heldout_top5": 1.0,
        "vqa_soft_accuracy": top1,
        "per_type_accuracy": {"is there": top1},
        "num_samples": 1299,
    }


class FakeRuns:
    """``sh`` stubbed: the evaluate step leaves evaluation_results.json
    where the runner reads it; the corpus and train steps only record."""

    def __init__(self, top1=0.75):
        self.top1, self.calls = top1, []

    def __call__(self, cmd, log_path=None):
        self.calls.append(cmd)
        if "vqa_tpu_torch.training.evaluate" in cmd:
            eval_dir = cmd[cmd.index("--output-dir") + 1]
            os.makedirs(eval_dir, exist_ok=True)
            with open(os.path.join(eval_dir, "evaluation_results.json"), "w") as f:
                json.dump({"top1_accuracy": self.top1, "top5_accuracy": 1.0,
                           "vqa_soft_accuracy": 0.76, "per_type_accuracy": {"is there": 0.8},
                           "num_samples": 1299}, f)


def test_mean_ci95_single_value_has_zero_halfwidth():
    m, ci = run_ablation.mean_ci95([0.7])
    assert m == 0.7 and ci == 0.0


def test_mean_ci95_three_values_uses_student_t():
    m, ci = run_ablation.mean_ci95([0.70, 0.72, 0.74])
    assert abs(m - 0.72) < 1e-12
    # sd = 0.02, t(2 df) = 4.303 -> 4.303 * 0.02 / sqrt(3)
    assert abs(ci - 4.303 * 0.02 / (3 ** 0.5)) < 1e-9


@pytest.mark.parametrize("values", [
    [0.7], [0.70, 0.72, 0.74], [0.7164, 0.6297, 0.8031], [0.5 + 0.01 * i for i in range(12)],
    [0.6 + 0.003 * (i % 7) for i in range(25)], [0.4 + 0.002 * i for i in range(40)]])
def test_mean_ci95_equals_the_jax_script(values):
    assert run_ablation.mean_ci95(values) == jax_run_ablation.mean_ci95(values)


def test_load_existing_migrates_old_single_seed_schema(tmp_path):
    old = {"seed": 42, "variants": {"full": _cell(0.70), "no_attention": _cell(0.69)}}
    p = tmp_path / "ABLATION.json"
    p.write_text(json.dumps(old))
    cells = run_ablation._load_existing(str(p))
    assert cells[("full", 42)]["heldout_top1"] == 0.70
    assert cells[("no_attention", 42)]["heldout_top1"] == 0.69
    assert cells == jax_run_ablation._load_existing(str(p))


def test_load_existing_reads_per_seed_schema(tmp_path):
    new = {"seeds": [7, 42], "variants": {"full": {
        "per_seed": {"7": _cell(0.71), "42": _cell(0.70)},
        "n_seeds": 2, "mean_heldout_top1": 0.705, "ci95_heldout_top1": 0.01}}}
    p = tmp_path / "ABLATION.json"
    p.write_text(json.dumps(new))
    cells = run_ablation._load_existing(str(p))
    assert set(cells) == {("full", 7), ("full", 42)}


def test_partial_rerun_preserves_other_variants(tmp_path, monkeypatch):
    """--variants full must not drop no_attention cells already in --out."""
    out = tmp_path / "ABLATION.json"
    out.write_text(json.dumps({"seeds": [42], "variants": {
        "no_attention": {"per_seed": {"42": _cell(0.69)}, "n_seeds": 1,
                         "mean_heldout_top1": 0.69, "ci95_heldout_top1": 0.0}}}))
    monkeypatch.setattr(run_ablation, "ensure_corpus", lambda *a, **k: None)
    monkeypatch.setattr(run_ablation, "sh", FakeRuns())
    monkeypatch.chdir(tmp_path)
    run_ablation.main(["--variants", "full", "--seeds", "7,42", "--out", str(out)])
    final = json.loads(out.read_text())
    assert set(final["variants"]) == {"full", "no_attention"}
    assert final["variants"]["no_attention"]["per_seed"]["42"]["heldout_top1"] == 0.69
    full = final["variants"]["full"]
    assert set(full["per_seed"]) == {"7", "42"} and full["n_seeds"] == 2
    assert final["seeds"] == [7, 42]


def test_cached_cells_are_not_rerun(tmp_path, monkeypatch):
    out = tmp_path / "ABLATION.json"
    out.write_text(json.dumps({"seeds": [42], "variants": {
        "full": {"per_seed": {"42": _cell(0.70)}, "n_seeds": 1,
                 "mean_heldout_top1": 0.70, "ci95_heldout_top1": 0.0}}}))
    runs = FakeRuns()
    monkeypatch.setattr(run_ablation, "ensure_corpus", lambda *a, **k: None)
    monkeypatch.setattr(run_ablation, "sh", runs)
    monkeypatch.chdir(tmp_path)
    run_ablation.main(["--variants", "full", "--seeds", "42", "--out", str(out)])
    assert runs.calls == []  # cell cached -> no train/eval subprocesses


def test_the_subprocesses_are_the_ports_modules(tmp_path, monkeypatch):
    """Corpora, training and evaluation run ``vqa_tpu_torch`` modules, with
    the JAX script's arguments; the train CLI gets each variant's flag.
    Without ``--out`` the table is printed, not written, and a rerun
    trains again."""
    runs = FakeRuns(top1=0.6)
    monkeypatch.setattr(run_ablation, "sh", runs)
    monkeypatch.chdir(tmp_path)
    argv = ["--seeds", "3", "--epochs", "2", "--train-corpus", "tr", "--val-corpus", "va",
            "--device", "cpu"]
    run_ablation.main(argv)
    modules = [c[c.index("-m") + 1] for c in runs.calls]
    assert modules == ["vqa_tpu_torch.tools.make_vqa_corpus"] * 2 + [
        "vqa_tpu_torch.training.train", "vqa_tpu_torch.training.evaluate"] * 3
    assert not any(m == "vqa_tpu" or m.startswith("vqa_tpu.") for c in runs.calls for m in c)
    corpus_train, corpus_val = runs.calls[:2]
    assert corpus_train[corpus_train.index("--seed") + 1] == "42" and "--spatial" in corpus_train
    assert corpus_val[corpus_val.index("--seed") + 1] == "4242" and "--spatial" in corpus_val
    trains = runs.calls[2::2]
    assert [[f for f in t if f in ("--no-spatial", "--no-attention")] for t in trains] == [
        [], ["--no-spatial"], ["--no-attention"]]
    for t in trains:
        assert t[t.index("--epochs") + 1] == "2" and "--device-aug" in t
        assert t[t.index("--device") + 1] == "cpu"
        assert t[t.index("--questions") + 1] == "tr/questions.json"
    evals = runs.calls[3::2]
    assert all(e[e.index("--questions") + 1] == "va/questions.json" for e in evals)
    assert os.listdir(tmp_path) == ["checkpoints"]  # evaluation results only, no table
    run_ablation.main(argv)
    assert len(runs.calls) == 2 * 8
