"""Word-level question tokenizer.

A copy of ``vqa_tpu/utils/tokenizer.py`` (importing that module would pull
in jax through ``vqa_tpu/utils/__init__.py``): same special tokens and
indices, same text normalization, same frequency-sorted vocab, same
pad/truncate semantics (END survives truncation) and the same JSON schema
(``{"word2idx", "max_length", "max_vocab_size"}``), so ids and saved
artifacts are identical between the two packages.

``encode_batch_np`` produces padded ``int32`` numpy arrays: fixed shapes
let the engine pad requests to its batch buckets. It is the engine's
per-dispatch tokenizer, so it does the normalization of a whole batch in
one pass over the joined text and builds the ids as one flat buffer; its
ids and masks are ``encode``'s, row for row.

The normalization is the JAX tokenizer's two regular expressions
(``[^\\w\\s']`` → space, then ``\\s+`` → one space, stripped) done as one
``str.translate`` and ``str.split``: ``\\w`` and ``\\s`` are
``str.isalnum()``/``_`` and ``str.isspace()``, the classes ``split``
breaks on, so the collapse was already ``split``'s.
"""

from __future__ import annotations

import array
import json
import os
from collections import Counter
from itertools import repeat
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


class _PunctTable(dict):
    """``str.translate`` table of the JAX tokenizer's ``[^\\w\\s']`` → space:
    a code point maps to itself where it is a word character (alphanumeric
    or ``_``), whitespace or an apostrophe, else to a space. Filled on
    first sight of each code point."""

    def __missing__(self, point: int) -> int:
        c = chr(point)
        self[point] = point if c.isalnum() or c.isspace() or c in "_'" else 32
        return self[point]


_PUNCT_TABLE = _PunctTable()
# joins a batch for one normalization pass: whitespace (so the table keeps
# it), neither cased nor case-ignorable (so ``lower`` treats it as the end
# of a string: the final-sigma rule sees each question alone)
_SEP = "\x1e"


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
        return " ".join(text.lower().translate(_PUNCT_TABLE).split())

    def tokenize(self, text: str) -> List[str]:
        return text.lower().translate(_PUNCT_TABLE).split()

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
        """Batch-encode to fixed-shape int32 arrays [N, max_length] for the
        device pipeline: ``encode``'s ids and masks (padded and truncated,
        END kept), the texts normalized in one pass and the ids written
        into one flat buffer, the masks made from the lengths."""
        n, length = len(texts), self.max_length
        if length < 2:  # truncation that keeps END needs room for two tokens
            ids, masks = self.batch_encode(texts, add_special_tokens)
            return np.asarray(ids, np.int32).reshape(n, length), np.asarray(
                masks, np.int32).reshape(n, length)
        parts = _SEP.join(texts).lower().translate(_PUNCT_TABLE).split(_SEP)
        if len(parts) != n:  # a text holds the separator itself
            parts = [t.lower().translate(_PUNCT_TABLE) for t in texts]
        get, unk = self.word2idx.get, repeat(UNK_IDX)
        start, end = get(START_TOKEN, UNK_IDX), get(END_TOKEN, UNK_IDX)
        keep = length - 2 if add_special_tokens else length
        flat, lengths = array.array("i"), []
        for part in parts:
            words = part.split()[:keep]
            if add_special_tokens:
                flat.append(start)
                flat.extend(map(get, words, unk))
                flat.append(end)
            else:
                flat.extend(map(get, words, unk))
            k = length - keep + len(words)
            flat.extend([PAD_IDX] * (length - k))
            lengths.append(k)
        ids = np.frombuffer(flat, np.int32).reshape(n, length)
        mask = (np.arange(length) < np.array(lengths)[:, None]).astype(np.int32)
        return ids, mask

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
