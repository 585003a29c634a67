"""Word-level question tokenizer.

A copy of ``vqa_tpu/utils/tokenizer.py`` (importing that module would pull
in jax through ``vqa_tpu/utils/__init__.py``): same special tokens and
indices, same text normalization, same frequency-sorted vocab, same
pad/truncate semantics (END survives truncation) and the same JSON schema
(``{"word2idx", "max_length", "max_vocab_size"}``), so ids and saved
artifacts are identical between the two packages.

``encode_batch_np`` produces padded ``int32`` numpy arrays: fixed shapes
let the engine pad requests to its batch buckets.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_TOKEN = "<PAD>"
UNK_TOKEN = "<UNK>"
START_TOKEN = "<START>"
END_TOKEN = "<END>"
SPECIAL_TOKENS = (PAD_TOKEN, UNK_TOKEN, START_TOKEN, END_TOKEN)
PAD_IDX = 0
UNK_IDX = 1
START_IDX = 2
END_IDX = 3

_PUNCT_RE = re.compile(r"[^\w\s']")
_SPACE_RE = re.compile(r"\s+")


class Tokenizer:
    """Word-level tokenizer with fixed-length padding."""

    def __init__(self, max_length: int = 20, vocab_size: Optional[int] = None):
        self.max_length = max_length
        self.max_vocab_size = vocab_size
        self.word2idx: Dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
        self.idx2word: Dict[int, str] = {i: t for i, t in enumerate(SPECIAL_TOKENS)}
        self._is_fitted = False

    @property
    def vocab_size(self) -> int:
        return len(self.word2idx)

    @staticmethod
    def preprocess(text: str) -> str:
        """Lowercase, replace punctuation (except apostrophes) with spaces,
        collapse whitespace (reference: utils/tokenizer.py:94-124)."""
        text = _PUNCT_RE.sub(" ", text.lower())
        return _SPACE_RE.sub(" ", text).strip()

    def tokenize(self, text: str) -> List[str]:
        return self.preprocess(text).split()

    def build_vocab(self, questions: Sequence[str], min_freq: int = 2) -> None:
        """Frequency-sorted vocab; words below min_freq map to UNK
        (reference: utils/tokenizer.py:140-194)."""
        counts = Counter()
        for q in questions:
            counts.update(self.tokenize(q))

        kept = [w for w, c in counts.items() if c >= min_freq]
        kept.sort(key=lambda w: counts[w], reverse=True)
        if self.max_vocab_size is not None:
            kept = kept[: self.max_vocab_size - len(SPECIAL_TOKENS)]

        idx = len(SPECIAL_TOKENS)
        for w in kept:
            if w not in self.word2idx:
                self.word2idx[w] = idx
                self.idx2word[idx] = w
                idx += 1
        self._is_fitted = True
        print(f"[Tokenizer] Built vocabulary with {self.vocab_size} tokens")

    def encode(
        self,
        text: str,
        add_special_tokens: bool = True,
        padding: bool = True,
        truncation: bool = True,
    ) -> Tuple[List[int], List[int]]:
        """Encode to (token_ids, attention_mask); END survives truncation
        (reference: utils/tokenizer.py:196-250)."""
        tokens = self.tokenize(text)
        if add_special_tokens:
            tokens = [START_TOKEN] + tokens + [END_TOKEN]
        if truncation and len(tokens) > self.max_length:
            tokens = tokens[: self.max_length]
            if add_special_tokens:
                tokens[-1] = END_TOKEN
        ids = [self.word2idx.get(t, UNK_IDX) for t in tokens]
        mask = [1] * len(ids)
        if padding and len(ids) < self.max_length:
            pad = self.max_length - len(ids)
            ids.extend([PAD_IDX] * pad)
            mask.extend([0] * pad)
        return ids, mask

    def decode(self, token_ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        words = []
        for i in token_ids:
            w = self.idx2word.get(int(i), UNK_TOKEN)
            if skip_special_tokens and w in SPECIAL_TOKENS:
                continue
            words.append(w)
        return " ".join(words)

    def batch_encode(
        self, texts: Sequence[str], add_special_tokens: bool = True
    ) -> Tuple[List[List[int]], List[List[int]]]:
        ids, masks = [], []
        for t in texts:
            i, m = self.encode(t, add_special_tokens=add_special_tokens)
            ids.append(i)
            masks.append(m)
        return ids, masks

    def encode_batch_np(
        self, texts: Sequence[str], add_special_tokens: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-encode to fixed-shape int32 arrays for the device pipeline."""
        ids, masks = self.batch_encode(texts, add_special_tokens)
        return (
            np.asarray(ids, dtype=np.int32),
            np.asarray(masks, dtype=np.int32),
        )

    def save(self, filepath: str) -> None:
        """Reference-compatible JSON (reference: utils/tokenizer.py:276-290)."""
        data = {
            "word2idx": self.word2idx,
            "max_length": self.max_length,
            "max_vocab_size": self.max_vocab_size,
        }
        d = os.path.dirname(filepath)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)
        print(f"[Tokenizer] Saved vocabulary to {filepath}")

    def load(self, filepath: str) -> None:
        with open(filepath, "r", encoding="utf-8") as f:
            data = json.load(f)
        self.word2idx = data["word2idx"]
        self.idx2word = {int(v): k for k, v in self.word2idx.items()}
        self.max_length = data.get("max_length", self.max_length)
        self.max_vocab_size = data.get("max_vocab_size", self.max_vocab_size)
        self._is_fitted = True
        print(f"[Tokenizer] Loaded vocabulary with {self.vocab_size} tokens")


def create_tokenizer_from_questions(
    questions: Sequence[str],
    max_length: int = 20,
    vocab_size: Optional[int] = 10000,
    min_freq: int = 2,
    save_path: Optional[str] = None,
) -> Tokenizer:
    """Factory (reference: utils/tokenizer.py:340-366)."""
    tok = Tokenizer(max_length=max_length, vocab_size=vocab_size)
    tok.build_vocab(questions, min_freq=min_freq)
    if save_path:
        tok.save(save_path)
    return tok
