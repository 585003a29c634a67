"""Write the committed Orbax fixture: a JAX trainer's checkpoint at a
narrow config with 224 px input, as ``vqa_tpu.training.checkpoint``
saves it, plus what a reader needs to check itself against it.

    JAX_PLATFORMS=cpu python tests/fixtures/orbax_narrow/make_fixture.py

It writes, beside itself:

- ``best_model/`` and ``best_model.meta.json``: the trainer tree
  (params, batch_stats, opt_state, step) after two AdamW steps on seeded
  batches, saved by ``save_checkpoint``;
- ``tokenizer.json`` and ``answer_vocab.json``;
- ``expected.npz``: the JAX engine's f32 probabilities for the requests
  of ``inputs.py`` (``probs``, ``questions``), and the SHA-256 of every
  array leaf's bytes (``names``, ``sha256``; key paths joined by dots,
  sequence indices as numbers), as ASCII byte strings.

    JAX_PLATFORMS=cpu python tests/fixtures/orbax_narrow/make_fixture.py \\
        --full-width DIR

writes instead two full-width ``ModelConfig()`` checkpoints of seeded
values (no compile), for timing a read
(``python -m vqa_tpu_torch.tools.checkpoint_read``): ``DIR/params/best_model``
(params and batch_stats) and ``DIR/trainer/best_model`` (with AdamW's
moments and a step, as a trainer saves them).

    JAX_PLATFORMS=cpu python tests/fixtures/orbax_narrow/make_fixture.py --resumed

writes only ``resumed.npz`` beside itself, leaving every other file as it
is: the JAX trainer resumed from ``best_model`` (``load_checkpoint`` with
a target) with dropout off, then three train steps on the first four
requests of ``inputs.py`` (``images(4)``, normalized as in the two steps
that made the tree), the labels rotated per step: the batches (``ids``,
``mask``, ``labels``, one row per step), the ``losses``, and every leaf of
the ``params`` and ``batch_stats`` after the third step, named by its key
path joined with dots (``params.answer_head.fc1.kernel``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import inputs  # noqa: E402
from vqa_tpu.data.vocab import AnswerVocabulary  # noqa: E402
from vqa_tpu.models import create_vqa_model, init_vqa_model  # noqa: E402
from vqa_tpu.serving.engine import VQAInference  # noqa: E402
from vqa_tpu.training import checkpoint as ckpt_lib  # noqa: E402
from vqa_tpu.training.train import TrainState, make_optimizer, make_train_step  # noqa: E402
from vqa_tpu.utils.config import InferenceConfig, ModelConfig, TrainingConfig  # noqa: E402
from vqa_tpu.utils.tokenizer import create_tokenizer_from_questions  # noqa: E402

ANSWERS = ["yes", "no", "red", "blue", "two", "three", "cat", "dog", "table", "left", "right",
           "ball"]
CORPUS = list(inputs.QUESTIONS) + ["what is the man holding", "is it raining",
                                   "how many people are on the bench"]


def leaves(tree, path=()):
    """(dotted key path, array) of every array leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    elif tree is not None and not isinstance(tree, (int, float)):
        yield ".".join(path), np.asarray(tree)


def full_width(out: str) -> None:
    """The two full-width checkpoints of ``--full-width``."""
    cfg = ModelConfig()
    model = create_vqa_model(config=cfg)
    shapes = jax.eval_shape(lambda: init_vqa_model(model, jax.random.PRNGKey(0)))
    tx, _ = make_optimizer(TrainingConfig(), 100)
    rng = np.random.default_rng(14)

    def fill(path, s):
        # AdamW's step counts, mu ~ gradients, nu ~ their squares
        if s.dtype == jnp.int32:
            return np.full(s.shape, 250, s.dtype)
        x = rng.standard_normal(s.shape).astype(s.dtype)
        names = {getattr(k, "name", None) for k in path}
        return x * 1e-3 if "mu" in names else x * x * 1e-6 if "nu" in names else x

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    opt_state = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(tx.init, shapes["params"]))
    meta = {"epoch": 10, "best_val_accuracy": 0.5, "metrics_history": {}}
    for kind, tree in (("params", dict(variables)),
                       ("trainer", {**variables, "opt_state": opt_state,
                                    "step": np.asarray(250, np.int32)})):
        base = os.path.join(out, kind)
        os.makedirs(base, exist_ok=True)
        ckpt_lib.save_checkpoint(base, "best_model", tree, cfg, meta)
        print(f"wrote {base}/best_model")


def resumed(out: str) -> None:
    """``--resumed``: the three steps after a resume from ``best_model``."""
    import dataclasses

    from vqa_tpu.utils.tokenizer import Tokenizer

    _, cfg, _ = ckpt_lib.load_checkpoint(HERE, "best_model")
    model = create_vqa_model(config=dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0))
    shapes = jax.eval_shape(lambda: init_vqa_model(model, jax.random.PRNGKey(0)))
    tx, _ = make_optimizer(TrainingConfig(warmup_epochs=0), 2)
    target = {"params": shapes["params"], "batch_stats": shapes["batch_stats"],
              "opt_state": jax.eval_shape(tx.init, shapes["params"]),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    tree, _, _ = ckpt_lib.load_checkpoint(HERE, "best_model", target)
    state = TrainState.create(apply_fn=model.apply, params=tree["params"], tx=tx,
                              batch_stats=tree["batch_stats"])
    state = state.replace(opt_state=tree["opt_state"], step=tree["step"])
    tok = Tokenizer()
    tok.load(os.path.join(HERE, "tokenizer.json"))
    ids, mask = tok.encode_batch_np(list(inputs.QUESTIONS[:4]))
    images = jnp.asarray(inputs.images(4).astype(np.float32) / 255.0 - 0.5)
    step = make_train_step(model)
    labels, losses = [], []
    for i in range(3):
        labels.append((np.arange(4) + 2 + 3 * i) % len(ANSWERS))
        state, m = step(state, images, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(labels[-1], jnp.int32), jax.random.PRNGKey(10 + i))
        losses.append(float(m["loss"]))
    after = dict(leaves({"params": state.params, "batch_stats": state.batch_stats}))
    np.savez_compressed(out, ids=np.stack([ids] * 3).astype(np.int32),
                        mask=np.stack([mask] * 3).astype(np.int32),
                        labels=np.stack(labels).astype(np.int32),
                        losses=np.asarray(losses, np.float64), step=int(state.step),
                        **{k: v.astype(np.float32) for k, v in after.items()})
    print(f"wrote {out}: losses {losses}, step {int(state.step)}, {len(after)} arrays")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full-width", default=None, metavar="DIR")
    p.add_argument("--resumed", action="store_true")
    args = p.parse_args()
    if args.resumed:
        resumed(os.path.join(HERE, "resumed.npz"))
        return
    if args.full_width:
        full_width(args.full_width)
        return
    tok = create_tokenizer_from_questions(CORPUS, max_length=12, vocab_size=100, min_freq=1)
    vocab = AnswerVocabulary(num_answers=len(ANSWERS))
    vocab.build_from_qa_pairs([{"answer": a} for a in ANSWERS])
    cfg = ModelConfig(vocab_size=tok.vocab_size, num_answers=len(ANSWERS), embed_dim=32,
                      num_transformer_layers=1, num_attention_heads=4, ffn_hidden_dim=64,
                      max_question_length=12, image_size=224,
                      base_channels=8, stage_channels=(8, 16, 16, 32),
                      blocks_per_stage=(1, 1, 1, 1), feature_spatial_size=7)
    model = create_vqa_model(config=cfg)
    variables = init_vqa_model(model, jax.random.PRNGKey(14))
    tx, _ = make_optimizer(TrainingConfig(warmup_epochs=0), 2)
    state = TrainState.create(apply_fn=model.apply, params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    step = make_train_step(model)
    pixels = inputs.images(4)
    ids, mask = tok.encode_batch_np(list(inputs.QUESTIONS[:4]))
    images = jnp.asarray(pixels.astype(np.float32) / 255.0 - 0.5)
    for i in range(2):
        state, _ = step(state, images, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(np.arange(4) + i, jnp.int32), jax.random.PRNGKey(i))

    for name in ("best_model", "best_model.meta.json", "tokenizer.json", "answer_vocab.json",
                 "expected.npz"):
        path = os.path.join(HERE, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    tree = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step}
    ckpt_lib.save_checkpoint(HERE, "best_model", tree, cfg, {
        "epoch": 1, "best_val_accuracy": 0.25,
        "metrics_history": {"train_loss": [2.5, 2.4], "val_accuracy": [0.2, 0.25]}})
    tok.save(os.path.join(HERE, "tokenizer.json"))
    vocab.save(os.path.join(HERE, "answer_vocab.json"))

    restored, _, _ = ckpt_lib.load_checkpoint(HERE, "best_model")
    named = list(leaves(restored))
    engine = VQAInference(checkpoint_dir=HERE, config=InferenceConfig(batch_buckets=(8,)),
                          dtype=jnp.float32).load()
    probs = engine.predict_probs_from_pixels(inputs.images(), list(inputs.QUESTIONS))
    np.savez_compressed(
        os.path.join(HERE, "expected.npz"), probs=probs.astype(np.float32),
        questions=np.array(inputs.QUESTIONS, "S"),
        names=np.array([n for n, _ in named], "S"),
        sha256=np.array([hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
                         for _, a in named], "S"))
    print(f"wrote {len(named)} arrays, probs {probs.shape}, top answers "
          f"{[vocab.decode(int(i)) for i in probs.argmax(-1)]}")


if __name__ == "__main__":
    main()
