"""Weights, vocabularies and the deployment directory, all from the seed.

The state_dict is drawn on the device by one `torch.Generator` there, in two
calls (one normal, one uniform draw over every entry at once), and cut into
the reference layout that `reference/model.py:param_shapes` lists:

- convolutions: N(0, 2 / fan_out) (Kaiming, fan-out);
- linear layers: N(0, 1 / fan_in); the cross-attention projections and the
  answer head: uniform in +-sqrt(6 / (fan_in + fan_out)) (Xavier);
- biases N(0, 0.02); the token embedding N(0, 1 / d) with the <PAD> row 0;
  the learned image position table N(0, 0.02); the sinusoidal table as the
  reference computes it;
- LayerNorm: weight 1 + N(0, 0.1), bias N(0, 0.05);
- BatchNorm: weight uniform in [0.5, 1.5), bias N(0, 0.1), running mean
  N(0, 0.1), running variance uniform in [0.5, 1.5), so that folding BN
  into the convolutions has something to fold.

The deployment directory is what a user hands the server: the port's
checkpoint (`<name>.pt`, `{"model_state_dict": ...}`, beside
`<name>.meta.json`, `{"config": ..., "meta": ...}`), `tokenizer.json`
(`{"word2idx", "max_length", "max_vocab_size"}`) and `answer_vocab.json`
(`{"num_answers", "answer2idx", "answer_counts"}`).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import param_shapes, sinusoid

CHECKPOINT = "bench_model"
SPECIALS = ("<PAD>", "<UNK>", "<START>", "<END>")
_SYLLABLES = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]


def make_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state_dict of `cfg` drawn from `seed` on `device`, float32."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, (shape, kind) in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "conv":
            t = z * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "linear":
            t = z * math.sqrt(1.0 / shape[1])
        elif kind == "xavier":
            t = (u * 2 - 1) * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind == "bias":
            t = z * 0.02
        elif kind == "embedding":
            t = z * shape[1] ** -0.5
            t[0] = 0.0
        elif kind == "position":
            t = z * 0.02
        elif kind == "sinusoid":
            t = torch.from_numpy(sinusoid(shape[1], shape[2]))[None].to(device)
        elif kind == "ln_weight":
            t = 1.0 + 0.1 * z
        elif kind == "ln_bias":
            t = 0.05 * z
        elif kind in ("bn_weight", "bn_var"):
            t = 0.5 + u
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * z
        elif kind == "count":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:
            raise ValueError(f"{key}: no rule to draw a {kind!r} entry")
        out[key] = t.clone()
    return out


def words(n: int, seed: int) -> List[str]:
    """n distinct lowercase words of 2-4 syllables, drawn from `seed`."""
    rng = np.random.default_rng([seed, 0x70CE])
    seen, out = set(), []
    while len(out) < n:
        w = "".join(rng.choice(_SYLLABLES, size=int(rng.integers(2, 5))))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def questions(vocab: List[str], count: int, min_words: int, max_words: int,
              seed: int) -> List[str]:
    """`count` questions whose lengths run evenly over min..max words (the
    same multiset for every seed, in the seed's order), words drawn from
    `vocab` by the seed."""
    rng = np.random.default_rng([seed, 0x9E57])
    lengths = np.resize(np.arange(min_words, max_words + 1), count)
    rng.shuffle(lengths)
    return [" ".join(rng.choice(vocab, size=int(n))) + "?" for n in lengths]


def write_deployment(directory: str, cfg: dict, state: Dict[str, torch.Tensor],
                     vocab: List[str]) -> Dict[str, torch.Tensor]:
    """The checkpoint, tokenizer and answer vocabulary a server loads;
    returns the state_dict's host copy, the one written."""
    os.makedirs(directory, exist_ok=True)
    cpu = {k: v.detach().to("cpu") for k, v in state.items()}
    torch.save({"model_state_dict": cpu}, os.path.join(directory, CHECKPOINT + ".pt"))
    with open(os.path.join(directory, CHECKPOINT + ".meta.json"), "w") as f:
        json.dump({"config": cfg, "meta": {"written_by": "benchmark"}}, f)
    with open(os.path.join(directory, "tokenizer.json"), "w") as f:
        json.dump({"word2idx": word_table(vocab), "max_length": cfg["max_question_length"],
                   "max_vocab_size": cfg["vocab_size"]}, f)
    answers = {f"answer_{i:04d}": i for i in range(cfg["num_answers"])}
    with open(os.path.join(directory, "answer_vocab.json"), "w") as f:
        json.dump({"num_answers": cfg["num_answers"], "answer2idx": answers,
                   "answer_counts": {}}, f)
    return cpu


def word_table(vocab: List[str]) -> Dict[str, int]:
    """word -> id as `write_deployment` writes it."""
    table = {w: i for i, w in enumerate(SPECIALS)}
    table.update({w: i + len(SPECIALS) for i, w in enumerate(vocab)})
    return table
