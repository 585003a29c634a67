"""Measure cross-attention faithfulness on held-out spatial scenes.

    python -m vqa_tpu_torch.tools.attention_faithfulness \
        --checkpoint-dir checkpoints/spatial --corpus data/vqa_synth_spatial_val
    python -m vqa_tpu_torch.tools.attention_faithfulness --device cpu \
        --checkpoint-dir D --corpus C --out faithfulness.json

Counterpart of ``scripts/attention_faithfulness.py:1-160``. For every
held-out spatially grounded question of a corpus written by
``tools/make_vqa_corpus.py --spatial`` ("what color is the shape in the
top left", "what shape is in the bottom right") it computes the share of
the question's cross-attention mass that lands in the queried quadrant of
the image grid (``utils/attention_analysis.py``). Uniform attention scores
0.25; a model that looks where the question points scores more.

The maps are the cross-attention kernel's probabilities output, from the
model's eval forward, averaged over layers and heads
(``models/fusion.py:attention_visualization``) and over the question's
tokens by its mask. The checkpoint is the port's (``training/checkpoint.py:
load_model_for_inference``), on the card unless ``--device cpu``; its
tokenizer and answer vocabulary are read from the checkpoint directory.
Prints the JAX script's JSON (``overall``, ``by_position``,
``by_question_type``: n, mean, median, p10, p90, ``frac_above_uniform``;
``top1_on_spatial_questions``); writes it to a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from vqa_tpu_torch.utils.attention_analysis import (
    QUADRANT_NAMES,
    position_from_question,
    quadrant_masses,
)

UNIFORM = 0.25


def spatial_questions(dataset) -> List[Tuple[int, int, str]]:
    """(sample index, queried quadrant, question type) of every sample whose
    question names a quadrant."""
    picked = [(i, position_from_question(s["question"]), s["question_type"])
              for i, s in enumerate(dataset.samples)]
    return [t for t in picked if t[1] is not None]


@torch.inference_mode()
def spatial_quadrant_masses(model, dataset, indices, batch_size: int = 64):
    """Eval forwards over ``dataset[indices]`` on the model's device:
    ([N, 4] quadrant masses of each question's cross-attention, [N] top-1
    answer indices)."""
    from vqa_tpu_torch.data.dataset import BatchLoader
    from vqa_tpu_torch.models.fusion import attention_visualization

    device = next(model.parameters()).device
    side = model.config.feature_spatial_size
    loader = BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                         indices=indices)
    masses, preds = [], []
    for batch in loader:
        logits, aux = model(torch.from_numpy(batch["image"]).to(device),
                            torch.from_numpy(batch["token_ids"]).to(device).long(),
                            torch.from_numpy(batch["attention_mask"]).to(device),
                            return_aux=True)
        maps = attention_visualization(aux["cross_attention_weights"], side)
        valid = int(batch["valid"])
        qm = quadrant_masses(maps.float().cpu().numpy(), batch["attention_mask"])
        masses.append(qm[:valid])
        preds.append(logits.argmax(-1).cpu().numpy()[:valid])
    return np.concatenate(masses), np.concatenate(preds)


def _stats(x) -> dict:
    x = np.asarray(x, np.float64)
    return {
        "n": int(x.size),
        "mean": round(float(x.mean()), 4),
        "median": round(float(np.median(x)), 4),
        "p10": round(float(np.percentile(x, 10)), 4),
        "p90": round(float(np.percentile(x, 90)), 4),
        "frac_above_uniform": round(float((x > UNIFORM).mean()), 4),
    }


def faithfulness(model, dataset, batch_size: int = 64) -> dict:
    """The queried-quadrant mass over ``dataset``'s spatial questions:
    overall, by queried position and by question type, on the questions the
    model answers right and wrong, and its top-1 on them."""
    picked = spatial_questions(dataset)
    if not picked:
        raise ValueError("the dataset holds no spatial questions")
    indices = [i for i, _, _ in picked]
    masses, preds = spatial_quadrant_masses(model, dataset, indices, batch_size)
    queried = np.array([q for _, q, _ in picked])
    qtypes = [t for _, _, t in picked]
    targets = np.array([dataset.samples[i]["answer"] for i in indices])
    at_queried = masses[np.arange(len(picked)), queried]
    correct = preds == targets
    return {
        "uniform_baseline": UNIFORM,
        "overall": _stats(at_queried),
        "by_position": {name: _stats(at_queried[queried == i])
                        for i, name in enumerate(QUADRANT_NAMES) if (queried == i).any()},
        "by_question_type": {t: _stats(at_queried[[qt == t for qt in qtypes]])
                             for t in sorted(set(qtypes))},
        "on_correct_answers": _stats(at_queried[correct]) if correct.any() else None,
        "on_wrong_answers": _stats(at_queried[~correct]) if (~correct).any() else None,
        "top1_on_spatial_questions": round(float(correct.mean()), 4),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--checkpoint", default="best_model")
    p.add_argument("--corpus", required=True,
                   help="a directory written by tools/make_vqa_corpus.py --spatial")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cpu only when asked")
    p.add_argument("--out", default=None, help="also write the JSON result here")
    args = p.parse_args(argv)

    from vqa_tpu_torch.data.dataset import VQADataset
    from vqa_tpu_torch.data.vocab import AnswerVocabulary
    from vqa_tpu_torch.training.checkpoint import load_model_for_inference
    from vqa_tpu_torch.utils.tokenizer import Tokenizer

    model = load_model_for_inference(args.checkpoint_dir, args.checkpoint, device=args.device)
    tokenizer = Tokenizer()
    tokenizer.load(os.path.join(args.checkpoint_dir, "tokenizer.json"))
    vocab = AnswerVocabulary()
    vocab.load(os.path.join(args.checkpoint_dir, "answer_vocab.json"))
    dataset = VQADataset(
        os.path.join(args.corpus, "questions.json"),
        os.path.join(args.corpus, "annotations.json"),
        os.path.join(args.corpus, "images"),
        tokenizer=tokenizer, answer_vocab=vocab, is_training=False,
        image_size=model.config.image_size)
    payload = {"checkpoint_dir": args.checkpoint_dir, "corpus": args.corpus,
               **faithfulness(model, dataset, args.batch_size)}
    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
