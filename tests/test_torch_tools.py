"""The port's attention analysis and its tools against the JAX package.

- ``utils/attention_analysis.py`` equals ``vqa_tpu/utils/attention_analysis.py``
  on random maps and on the cases of ``tests/test_attention_analysis.py``;
- ``tools/make_vqa_corpus.py`` and ``scripts/make_vqa_corpus.py``, run in
  one process with the same tiny ``--spatial`` arguments, write equal JSON
  and equal decoded images;
- the faithfulness tool's per-question quadrant masses on that corpus,
  from a tiny JAX model's weights carried into the port, within 1e-5 of the
  same masses in JAX (``model.apply(..., return_aux=True)`` →
  ``attention_visualization`` → ``quadrant_masses``);
- the visualization heats within 1e-5 of the JAX script's;
- the two tools' command lines on a port checkpoint: the JSON written only
  with ``--out``, the PNGs, and a refusal without a card unless the CPU is
  asked for.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vqa_tpu.models import create_vqa_model as jax_create_vqa_model
from vqa_tpu.models import get_attention_maps as jax_get_attention_maps
from vqa_tpu.models import init_vqa_model
from vqa_tpu.models.fusion import attention_visualization as jax_attention_visualization
from vqa_tpu.utils import attention_analysis as jax_aa
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.data.dataset import BatchLoader, VQADataset
from vqa_tpu_torch.data.synthetic import POSITIONS
from vqa_tpu_torch.models.vqa_model import create_vqa_model, get_attention_maps
from vqa_tpu_torch.tools import attention_faithfulness, make_vqa_corpus, visualize_attention
from vqa_tpu_torch.utils import attention_analysis as aa
from vqa_tpu_torch.utils.config import model_config_from_dict
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CORPUS = dict(num_images=10, questions_per_image=3, image_size=80, seed=7, spatial=True,
              quality=70)
# a 3x3 feature grid (96 px): the middle row and column belong to no quadrant
TINY = dict(embed_dim=16, num_transformer_layers=1, num_attention_heads=2,
            ffn_hidden_dim=32, max_question_length=12, image_size=96, base_channels=8,
            stage_channels=(8, 16, 32, 64), feature_spatial_size=3, num_cross_layers=2)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_make_vqa_corpus", os.path.join(REPO, "scripts", "make_vqa_corpus.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- attention analysis -------------------------------------------------------


@pytest.mark.parametrize("side", [1, 2, 3, 4, 7, 8])
def test_quadrant_slices_equal_jax(side):
    assert aa.quadrant_slices(side) == jax_aa.quadrant_slices(side)


@pytest.mark.parametrize("side,masked", [(4, False), (7, False), (7, True), (3, True)])
def test_random_maps_equal_jax(side, masked):
    rng = np.random.default_rng(side)
    maps = rng.random((5, 6, side, side))
    maps /= maps.sum(axis=(2, 3), keepdims=True)
    mask = None
    if masked:
        mask = (rng.random((5, 6)) < 0.6).astype(np.int32)
        mask[2] = 0  # an all-zero row takes the unmasked mean
    np.testing.assert_array_equal(aa.aggregate_token_maps(maps, mask),
                                  jax_aa.aggregate_token_maps(maps, mask))
    got = aa.quadrant_masses(maps, mask)
    np.testing.assert_array_equal(got, jax_aa.quadrant_masses(maps, mask))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


def _delta_maps():
    out = []
    for rs, cs in aa.quadrant_slices(7):
        attn = np.zeros((1, 3, 7, 7))
        attn[:, :, rs.start, cs.start] = 1.0
        out.append(attn)
    return out


def _middle_map():
    attn = np.zeros((1, 1, 7, 7))
    attn[0, 0, 3, 3], attn[0, 0, 0, 0] = 0.9, 0.1
    return attn


def _pad_token_map():
    attn = np.zeros((1, 2, 4, 4))
    attn[0, 0, 0, 0] = attn[0, 1, 3, 3] = 1.0
    return attn


# the cases of tests/test_attention_analysis.py: (maps, mask, expected masses)
CASES = {
    "uniform_even": (np.full((2, 5, 4, 4), 1 / 16), None, np.full((2, 4), 0.25)),
    "uniform_odd": (np.full((2, 5, 7, 7), 1 / 49), None, np.full((2, 4), 0.25)),
    **{f"delta_{q}": (m, None, np.eye(4)[q][None]) for q, m in enumerate(_delta_maps())},
    "middle_excluded": (_middle_map(), None, np.array([[1.0, 0, 0, 0]])),
    "pad_token_masked": (_pad_token_map(), np.array([[1, 0]]), np.array([[1.0, 0, 0, 0]])),
    "pad_token_counted": (_pad_token_map(), None, np.array([[0.5, 0, 0, 0.5]])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_cases_give_the_same_masses(case):
    maps, mask, want = CASES[case]
    got = aa.quadrant_masses(maps, mask)
    np.testing.assert_array_equal(got, jax_aa.quadrant_masses(maps, mask))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_bad_shapes_are_rejected_as_in_jax():
    for bad in (np.zeros((2, 3)), np.zeros((1, 2, 4, 5))):
        with pytest.raises(ValueError, match="expected"):
            aa.quadrant_masses(bad)
        with pytest.raises(ValueError, match="expected"):
            jax_aa.quadrant_masses(bad)


def test_position_from_question_equals_jax():
    assert aa.QUADRANT_NAMES == jax_aa.QUADRANT_NAMES == POSITIONS
    questions = [f"what color is the shape in the {p}" for p in POSITIONS]
    questions += [f"What shape is in the {p}?" for p in POSITIONS]
    questions += ["how many shapes are there", "is there a circle", ""]
    got = [aa.position_from_question(q) for q in questions]
    assert got == [jax_aa.position_from_question(q) for q in questions]
    assert got == [0, 1, 2, 3, 0, 1, 2, 3, None, None, None]


# ---- the corpus ----------------------------------------------------------------


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The port's corpus (through its command line) and the JAX script's,
    written with the same arguments in this process."""
    root = tmp_path_factory.mktemp("corpora")
    port, ref = str(root / "port"), str(root / "jax")
    make_vqa_corpus.main([
        "--out", port, "--num-images", str(CORPUS["num_images"]), "--questions-per-image",
        str(CORPUS["questions_per_image"]), "--image-size", str(CORPUS["image_size"]),
        "--seed", str(CORPUS["seed"]), "--spatial", "--quality", str(CORPUS["quality"])])
    _jax_script().make_corpus(ref, **CORPUS)
    return port, ref


def test_corpus_equals_the_jax_scripts(corpora):
    port, ref = corpora
    for name in ("questions.json", "annotations.json", "corpus_meta.json"):
        with open(os.path.join(port, name)) as a, open(os.path.join(ref, name)) as b:
            assert json.load(a) == json.load(b), name
    images = sorted(os.listdir(os.path.join(port, "images")))
    assert images == sorted(os.listdir(os.path.join(ref, "images")))
    assert len(images) == CORPUS["num_images"] and images[0] == "000000000001.jpg"
    for name in images:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(port, "images", name))),
                                      np.asarray(Image.open(os.path.join(ref, "images", name))))
    with open(os.path.join(port, "annotations.json")) as f:
        anns = json.load(f)["annotations"]
    assert all(len(a["answers"]) == 10 for a in anns)
    with open(os.path.join(port, "questions.json")) as f:
        questions = json.load(f)["questions"]
    assert any(aa.position_from_question(q["question"]) is not None for q in questions)


# ---- faithfulness and visualization against JAX ----------------------------------


@pytest.fixture(scope="module")
def models(corpora):
    """The corpus as the port's dataset, a tiny JAX model sized to it, and
    the port's model with its weights."""
    port_dir, _ = corpora
    ds = VQADataset(os.path.join(port_dir, "questions.json"),
                    os.path.join(port_dir, "annotations.json"),
                    os.path.join(port_dir, "images"), is_training=False,
                    image_size=TINY["image_size"], max_question_length=TINY["max_question_length"])
    jcfg = JaxModelConfig(vocab_size=ds.tokenizer.vocab_size,
                          num_answers=len(ds.answer_vocab.answer2idx), **TINY)
    jmodel = jax_create_vqa_model(config=jcfg, dtype=None)
    variables = init_vqa_model(jmodel, jax.random.PRNGKey(3))
    cfg = model_config_from_dict(model_config_dict(jcfg))
    model = create_vqa_model(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                                              cfg), strict=True)
    return ds, jmodel, variables, model


def test_faithfulness_masses_equal_jax(models):
    ds, jmodel, variables, model = models
    picked = attention_faithfulness.spatial_questions(ds)
    indices = [i for i, _, _ in picked]
    assert len(indices) >= 5
    masses, preds = attention_faithfulness.spatial_quadrant_masses(model, ds, indices,
                                                                   batch_size=4)
    side = jmodel.config.feature_spatial_size

    @jax.jit
    def spatial_maps(images, ids, mask):
        logits, aux = jmodel.apply(variables, images, ids, mask, train=False,
                                   return_aux=True)
        return logits.argmax(-1), jax_attention_visualization(
            aux["cross_attention_weights"], side)

    want, want_preds = [], []
    for batch in BatchLoader(ds, 4, shuffle=False, drop_last=False, indices=indices):
        top1, maps = spatial_maps(batch["image"], batch["token_ids"], batch["attention_mask"])
        valid = int(batch["valid"])
        want.append(jax_aa.quadrant_masses(np.asarray(maps), batch["attention_mask"])[:valid])
        want_preds.append(np.asarray(top1)[:valid])
    want = np.concatenate(want)
    assert masses.shape == want.shape == (len(indices), 4)
    np.testing.assert_allclose(masses, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(preds, np.concatenate(want_preds))

    out = attention_faithfulness.faithfulness(model, ds, batch_size=4)
    queried = np.array([q for _, q, _ in picked])
    assert out["overall"]["n"] == len(indices)
    assert out["overall"]["mean"] == round(float(masses[np.arange(len(queried)),
                                                        queried].mean()), 4)
    assert set(out) >= {"overall", "by_position", "by_question_type",
                        "top1_on_spatial_questions", "uniform_baseline"}
    for stats in [out["overall"], *out["by_position"].values(),
                  *out["by_question_type"].values()]:
        assert set(stats) == {"n", "mean", "median", "p10", "p90", "frac_above_uniform"}


def test_visualization_heats_equal_jax(models, corpora):
    ds, jmodel, variables, model = models
    sample = ds[0]
    images, ids, mask = sample["image"][None], sample["token_ids"][None], \
        sample["attention_mask"][None]
    side = jmodel.config.feature_spatial_size
    # the JAX script's heats (scripts/visualize_attention.py:68-74)
    maps = jax_get_attention_maps(jmodel, variables, images, ids, mask)
    valid = mask[0].astype(bool)
    want = {f"layer{i}": np.asarray(w)[0].mean(0).reshape(-1, side, side)[valid].mean(0)
            for i, w in enumerate(maps["cross_attention"])}
    want["mean"] = np.asarray(maps["cross_attention_spatial"])[0][valid].mean(0)

    got = visualize_attention.attention_heats(
        get_attention_maps(model, torch.from_numpy(images), torch.from_numpy(ids).long(),
                           torch.from_numpy(mask)), mask[0], side)
    assert sorted(got) == sorted(want) == ["layer0", "layer1", "mean"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=TOL)
    pixels = np.zeros((96, 96, 3), np.uint8)
    blended = visualize_attention.overlay(pixels, got["mean"])
    assert blended.shape == (96, 96, 3) and blended.dtype == np.uint8
    assert blended[..., 0].max() > 0 and blended[..., 1:].max() == 0


# ---- the command lines ------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(corpora, tmp_path_factory):
    """A port checkpoint: the train CLI, tiny, one epoch on the port's corpus
    (in its own process: a torch backward after XLA has run in this one is
    not safe on this host's oneDNN)."""
    port_dir, _ = corpora
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.training.train", "--tiny", "--device", "cpu",
         "--questions", os.path.join(port_dir, "questions.json"),
         "--annotations", os.path.join(port_dir, "annotations.json"),
         "--images-dir", os.path.join(port_dir, "images"), "--epochs", "1",
         "--batch-size", "8", "--checkpoint-dir", ckpt],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ckpt


def test_faithfulness_cli_writes_json_only_with_out(checkpoint, corpora, tmp_path,
                                                    monkeypatch, capsys):
    port_dir, _ = corpora
    monkeypatch.chdir(tmp_path)
    args = ["--checkpoint-dir", checkpoint, "--checkpoint", "latest", "--corpus", port_dir,
            "--batch-size", "4"]
    assert attention_faithfulness.main(args + ["--device", "cpu"]) == 0
    assert '"overall"' in capsys.readouterr().out
    assert os.listdir(tmp_path) == []
    out = tmp_path / "faith.json"
    assert attention_faithfulness.main(args + ["--device", "cpu", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["checkpoint_dir"] == checkpoint and payload["corpus"] == port_dir
    assert payload["uniform_baseline"] == 0.25 and payload["overall"]["n"] > 0
    assert 0.0 <= payload["overall"]["mean"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attention_faithfulness.main(args)


def test_visualize_cli_writes_the_overlays(checkpoint, corpora, tmp_path):
    port_dir, _ = corpora
    image = os.path.join(port_dir, "images", "000000000001.jpg")
    args = ["--checkpoint-dir", checkpoint, "--checkpoint", "latest", "--image", image,
            "--question",
            "what color is the shape in the top left", "--out", str(tmp_path / "viz")]
    assert visualize_attention.main(args + ["--device", "cpu"]) == 0
    pngs = sorted(os.listdir(tmp_path / "viz"))
    assert pngs == ["cross_attention_layer0.png", "cross_attention_layer1.png",
                    "cross_attention_mean.png"]
    with Image.open(tmp_path / "viz" / pngs[-1]) as im:
        assert im.mode == "RGB" and im.size == (64, 64)  # the --tiny model's image size
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            visualize_attention.main(args)
