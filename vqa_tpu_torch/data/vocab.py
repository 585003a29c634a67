"""Answer vocabulary for 1000-way VQA answer classification.

A copy of ``vqa_tpu/data/vocab.py``; the port imports nothing of the JAX
package. Behavior- and artifact-compatible with the reference
(reference: data/build_vocab.py:31-329): VQA-v2-style answer normalization
(lowercase, strip articles and punctuation), frequency counting from either
annotation files (counts multiple_choice_answer + all 10 annotator answers)
or plain QA pairs (primary answer only — the reference has this asymmetry
too, data/build_vocab.py:131-140 vs :189-205), top-K mapping, -1 for OOV on
encode, ``<UNKNOWN>`` on bad decode, and the same JSON schema
(``{"num_answers", "answer2idx", "answer_counts"}``).
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence

_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT_RE = re.compile(r"[^\w\s]")
_SPACE_RE = re.compile(r"\s+")


class AnswerVocabulary:
    """Top-K answer vocabulary with VQA-v2 normalization."""

    def __init__(self, num_answers: int = 1000):
        self.num_answers = num_answers
        self.answer2idx: Dict[str, int] = {}
        self.idx2answer: Dict[int, str] = {}
        self.answer_counts: Dict[str, int] = {}
        self._is_built = False

    @staticmethod
    def preprocess_answer(answer: str) -> str:
        """VQA-v2 answer normalization (reference: data/build_vocab.py:61-93)."""
        answer = answer.lower()
        answer = _ARTICLE_RE.sub(" ", answer)
        answer = _PUNCT_RE.sub("", answer)
        return _SPACE_RE.sub(" ", answer).strip()

    def _finalize(self, counter: Counter, save_path: Optional[str]) -> None:
        self.answer_counts = dict(counter)
        for idx, (answer, _count) in enumerate(counter.most_common(self.num_answers)):
            self.answer2idx[answer] = idx
            self.idx2answer[idx] = answer
        self._is_built = True
        if save_path:
            self.save(save_path)

    def build_from_annotations(
        self, annotations_path: str, save_path: Optional[str] = None
    ) -> None:
        """Count multiple_choice_answer plus every annotator answer
        (reference: data/build_vocab.py:95-171)."""
        with open(annotations_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        counter: Counter = Counter()
        for ann in data["annotations"]:
            counter[self.preprocess_answer(ann["multiple_choice_answer"])] += 1
            for ans in ann.get("answers", []):
                counter[self.preprocess_answer(ans["answer"])] += 1
        print(f"[AnswerVocab] {len(counter)} unique answers; keeping top-{self.num_answers}")
        self._finalize(counter, save_path)

    def build_from_qa_pairs(
        self,
        qa_pairs: Sequence[dict],
        answer_key: str = "answer",
        save_path: Optional[str] = None,
    ) -> None:
        """Count only the primary answer per pair
        (reference: data/build_vocab.py:173-205)."""
        counter: Counter = Counter()
        for qa in qa_pairs:
            counter[self.preprocess_answer(qa[answer_key])] += 1
        self._finalize(counter, save_path)

    def encode(self, answer: str) -> int:
        return self.answer2idx.get(self.preprocess_answer(answer), -1)

    def decode(self, idx: int) -> str:
        return self.idx2answer.get(int(idx), "<UNKNOWN>")

    def is_valid_answer(self, answer: str) -> bool:
        return self.preprocess_answer(answer) in self.answer2idx

    def save(self, filepath: str) -> None:
        d = os.path.dirname(filepath)
        if d:
            os.makedirs(d, exist_ok=True)
        data = {
            "num_answers": self.num_answers,
            "answer2idx": self.answer2idx,
            "answer_counts": self.answer_counts,
        }
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)
        print(f"[AnswerVocab] Saved vocabulary to {filepath}")

    def load(self, filepath: str) -> None:
        with open(filepath, "r", encoding="utf-8") as f:
            data = json.load(f)
        self.num_answers = data["num_answers"]
        self.answer2idx = data["answer2idx"]
        self.idx2answer = {int(v): k for k, v in self.answer2idx.items()}
        self.answer_counts = data.get("answer_counts", {})
        self._is_built = True
        print(f"[AnswerVocab] Loaded vocabulary with {self.num_answers} answers")

    def get_answer_weights(self) -> List[float]:
        """Inverse-frequency class weights (reference: data/build_vocab.py:284-308)."""
        if not self.answer_counts:
            return [1.0] * self.num_answers
        total = sum(
            self.answer_counts.get(self.idx2answer.get(i, ""), 1)
            for i in range(self.num_answers)
        )
        weights = []
        for i in range(self.num_answers):
            count = self.answer_counts.get(self.idx2answer.get(i, ""), 1)
            weights.append(total / (len(self.answer2idx) * count))
        return weights


def create_answer_vocabulary(
    annotations_path: str,
    num_answers: int = 1000,
    save_path: Optional[str] = None,
) -> AnswerVocabulary:
    """Factory (reference: data/build_vocab.py:311-329)."""
    vocab = AnswerVocabulary(num_answers=num_answers)
    vocab.build_from_annotations(annotations_path, save_path)
    return vocab
