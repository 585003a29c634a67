"""The port's inference engine against the JAX engine, on a tiny config.

Both engines start from the same weights (the JAX engine's variables
carried into the port in memory) and answer the same requests: 1, 3
(padded to a bucket of 4) and 40 (chunked into buckets of 4) image and
question pairs, plus an attention map. Probabilities agree within 1e-4.
Tokenizer and answer-vocabulary artifacts must be identical.
"""

import io

import numpy as np
import pytest
from PIL import Image

from vqa_tpu.data.vocab import AnswerVocabulary as JaxVocab
from vqa_tpu.serving.engine import VQAInference as JaxInference
from vqa_tpu.utils.config import InferenceConfig as JaxInferenceConfig
from vqa_tpu.utils.config import ModelConfig as JaxModelConfig
from vqa_tpu.utils.config import model_config_dict
from vqa_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
from vqa_tpu_torch.compat.jax_weights import state_dict_from_jax
from vqa_tpu_torch.data.vocab import AnswerVocabulary
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.utils.config import InferenceConfig, model_config_from_dict
from vqa_tpu_torch.utils.tokenizer import Tokenizer
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(vocab_size=50, embed_dim=16, num_answers=8, num_transformer_layers=1,
            num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6,
            image_size=32, base_channels=8, stage_channels=(8, 16, 32, 64),
            feature_spatial_size=1)
QUESTIONS = ["what color is the cat", "how many dogs are there", "is this a man",
             "what is the woman wearing", "what"]


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxModelConfig(**TINY)
    jax_engine = JaxInference(model_config=jcfg,
                              config=JaxInferenceConfig(batch_buckets=(1, 4))).load()
    cfg = model_config_from_dict(model_config_dict(jcfg))
    engine = VQAInference(model_config=cfg, config=InferenceConfig(batch_buckets=(1, 4)),
                          device="cpu").load()
    engine.model.load_state_dict(state_dict_from_jax(jax_engine.variables, cfg),
                                 strict=True)
    return jax_engine, engine


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = rng.integers(20, 80, 2)
        out.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    # one PNG-encoded request, as the server passes bytes
    buf = io.BytesIO()
    Image.fromarray(out[0]).save(buf, "PNG")
    out[0] = buf.getvalue()
    return out


@pytest.mark.parametrize("n", [1, 3, 40])
def test_probabilities_match_jax_engine(engines, n):
    jax_engine, engine = engines
    images = _images(n, seed=n)
    questions = [QUESTIONS[i % len(QUESTIONS)] for i in range(n)]
    want = jax_engine.predict_batch_raw(images, questions)
    got = engine.predict_batch_raw(images, questions)
    assert got.shape == want.shape == (n, TINY["num_answers"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert np.abs(got - want).max() <= 1e-4


def test_predict_and_batch_results_match_jax_engine(engines):
    jax_engine, engine = engines
    images = _images(5, seed=7)
    got = engine.predict_batch(images, QUESTIONS, top_k=3)
    want = jax_engine.predict_batch(images, QUESTIONS, top_k=3)
    assert [r["question"] for r in got] == QUESTIONS
    for g, w in zip(got, want):
        assert len(g["answers"]) == 3
        np.testing.assert_allclose(g["confidence"], w["confidence"], atol=1e-4)
    single = engine.predict(images[1], QUESTIONS[1])
    assert single["top_answer"].startswith("answer_")
    assert engine.predict_batch_raw([], []).shape == (0, TINY["num_answers"])


def test_attention_map_matches_jax_engine(engines):
    jax_engine, engine = engines
    image = _images(1, seed=3)[0]
    got = engine.attention_map(image, "what color is the cat")
    want = jax_engine.attention_map(image, "what color is the cat")
    assert got["attention"]["tokens"] == want["attention"]["tokens"]
    assert got["attention"]["spatial_size"] == TINY["feature_spatial_size"]
    g, w = np.asarray(got["attention"]["maps"]), np.asarray(want["attention"]["maps"])
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=1e-4)
    np.testing.assert_allclose(got["confidence"], want["confidence"], atol=1e-4)


def test_model_info(engines):
    _, engine = engines
    info = engine.get_model_info()
    assert info["backend"] == "cpu" and info["parameters"]["total"] > 0


def test_tokenizer_ids_and_saved_json_are_identical(tmp_path):
    corpus = ["What color is the cat?", "How many dogs are there?", "what's this",
              "Is the man's hat red?", "what color is the dog"] * 2
    tok, jtok = Tokenizer(max_length=6, vocab_size=12), JaxTokenizer(max_length=6,
                                                                     vocab_size=12)
    tok.build_vocab(corpus, min_freq=1)
    jtok.build_vocab(corpus, min_freq=1)
    queries = corpus + ["an unseen question that is far too long to fit"]
    for a, b in zip(tok.encode_batch_np(queries), jtok.encode_batch_np(queries)):
        np.testing.assert_array_equal(a, b)
    tok.save(str(tmp_path / "t.json"))
    jtok.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    loaded = Tokenizer()
    loaded.load(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(loaded.encode_batch_np(queries)[0],
                                  jtok.encode_batch_np(queries)[0])


def test_answer_vocabulary_round_trips_identically(tmp_path):
    pairs = [{"answer": a} for a in ["Yes", "no", "yes", "the red one", "2", "two", "no"]]
    vocab, jvocab = AnswerVocabulary(num_answers=4), JaxVocab(num_answers=4)
    vocab.build_from_qa_pairs(pairs, save_path=str(tmp_path / "v.json"))
    jvocab.build_from_qa_pairs(pairs, save_path=str(tmp_path / "j.json"))
    assert (tmp_path / "v.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    loaded = AnswerVocabulary()
    loaded.load(str(tmp_path / "j.json"))
    assert loaded.answer2idx == jvocab.answer2idx
    assert [loaded.decode(i) for i in range(5)] == [jvocab.decode(i) for i in range(5)]
    assert loaded.encode("The red one!") == jvocab.encode("The red one!")


def test_engine_loads_reference_pth_checkpoint(tmp_path):
    """A reference-schema .pth (model_state_dict + config) loads strictly;
    the reference config keeps no CNN geometry, so the backbone is full
    width and the text side comes from the file."""
    import torch

    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.compat.jax_weights import REFERENCE_CONFIG_KEYS
    from vqa_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(vocab_size=30, embed_dim=16, num_answers=5, num_transformer_layers=1,
                      num_attention_heads=2, ffn_hidden_dim=32, max_question_length=6)
    model = create_vqa_model(config=cfg, device="cpu", seed=9)
    torch.save({"model_state_dict": model.state_dict(),
                "config": {k: getattr(cfg, k) for k in REFERENCE_CONFIG_KEYS}},
               tmp_path / "ref.pth")
    engine = VQAInference(checkpoint_dir=str(tmp_path), checkpoint_name="ref.pth",
                          device="cpu").load()
    assert engine.model_loaded_from_checkpoint
    assert engine.model.config == cfg
    for key, value in model.state_dict().items():
        torch.testing.assert_close(engine.model.state_dict()[key], value, rtol=0, atol=0)
    probs = engine.predict_batch_raw(_images(1), ["what is this"])
    assert probs.shape == (1, 5) and np.isfinite(probs).all()


def test_engine_refuses_an_orbax_checkpoint_dir(tmp_path):
    """An Orbax directory the port's reader cannot read (here: written with
    zarr3) stops the load with an error naming what it lacks; readable
    ones load (``tests/test_torch_orbax.py``)."""
    import json

    from vqa_tpu_torch.compat.orbax import OrbaxError

    (tmp_path / "best_model").mkdir()
    (tmp_path / "best_model" / "_METADATA").write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": True}))
    (tmp_path / "best_model.meta.json").write_text(json.dumps(
        {"config": model_config_dict(JaxModelConfig(**TINY)), "meta": {}}))
    engine = VQAInference(checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(OrbaxError, match="zarr3"):
        engine.load()
