"""The reference's own input preparation: question tokens.

`Vocabulary` turns a question into token ids as the reference repository's
word tokenizer does: lowercase, every character that is not a word
character, a space or an apostrophe becomes a space, split on spaces,
<START> + words + <END>, cut to the length with <END> kept last, unknown
words as <UNK> (1), padded with <PAD> (0); the mask is 1 on tokens.

The word table is the file the benchmark writes for the deployment
(`tokenizer.json`, `{"word2idx": ...}`); nothing the program derived from it
is read.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np

PAD, UNK, START, END = 0, 1, 2, 3
_PUNCT = re.compile(r"[^\w\s']")
_SPACE = re.compile(r"\s+")


class Vocabulary:
    def __init__(self, word2idx: Dict[str, int], max_length: int):
        self.word2idx = word2idx
        self.max_length = max_length

    def encode(self, question: str) -> Tuple[np.ndarray, np.ndarray]:
        words = _SPACE.sub(" ", _PUNCT.sub(" ", question.lower())).strip().split()
        ids = [START] + [self.word2idx.get(w, UNK) for w in words] + [END]
        if len(ids) > self.max_length:
            ids = ids[: self.max_length - 1] + [END]
        n = len(ids)
        out = np.full(self.max_length, PAD, np.int32)
        out[:n] = ids
        mask = np.zeros(self.max_length, np.int32)
        mask[:n] = 1
        return out, mask

    def encode_all(self, questions: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(q) for q in questions]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

