"""Metrics for VQA training and evaluation.

Counterpart of ``vqa_tpu/utils/metrics.py``, with the same semantics:
running top-1/top-5 accuracy with an optional per-question-type breakdown,
the official VQA soft accuracy ``min(1, agreement/3)``, a confusion matrix
and per-class accuracy, ``AverageMeter``, and a checkpoint-serializable
``MetricsLogger`` whose JSON is byte-identical to the JAX one.

The per-batch math works on tensors and stays on their device, so a train
loop fetches counts only when it needs them; the host accumulators take
either counts or raw arrays.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Metric math on tensors
# ---------------------------------------------------------------------------

def topk_flags(logits: torch.Tensor, targets: torch.Tensor, k: int = 5):
    """Per-sample (top1_correct, topk_correct) bool vectors.

    logits: [B, num_answers]; targets: [B] int. The target is in the top-k
    iff fewer than k logits are strictly greater than the target's.
    """
    targets = targets.long()
    top1 = logits.argmax(dim=-1)
    target_logit = logits.gather(-1, targets[:, None])
    rank = (logits > target_logit).sum(dim=-1)
    return top1 == targets, rank < k


def topk_correct(logits: torch.Tensor, targets: torch.Tensor, k: int = 5):
    """(top1_correct, topk_correct) as int32 counts (0-d tensors)."""
    f1, fk = topk_flags(logits, targets, k)
    return f1.sum(dtype=torch.int32), fk.sum(dtype=torch.int32)


def vqa_soft_scores(pred_idx: torch.Tensor, annotator_answer_idx: torch.Tensor):
    """Official VQA soft accuracy per sample: min(1, #agreeing annotators / 3).

    pred_idx: [B]; annotator_answer_idx: [B, 10] (-1 for out-of-vocab)."""
    agree = (annotator_answer_idx == pred_idx[:, None]).to(torch.float32).sum(dim=-1)
    return torch.clamp(agree / 3.0, max=1.0)


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[num_classes, num_classes] int32 counts, rows = target, cols = pred."""
    flat = targets.long() * num_classes + preds.long()
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int32, device=preds.device)
    cm.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return cm.view(num_classes, num_classes)


def per_class_accuracy(cm: torch.Tensor) -> torch.Tensor:
    """diag / rowsum, 0 for empty classes."""
    row = cm.sum(dim=1)
    acc = torch.diagonal(cm) / torch.clamp(row, min=1)
    return torch.where(row > 0, acc, torch.zeros_like(acc))


def compute_accuracy(logits, targets, k: int = 5) -> Dict[str, float]:
    """One-shot top-1/top-k accuracy."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets)
    c1, ck = topk_correct(logits, targets, k)
    n = targets.shape[0]
    return {"top1": float(c1) / n, f"top{k}": float(ck) / n}


# ---------------------------------------------------------------------------
# Host-side accumulators
# ---------------------------------------------------------------------------

class VQAAccuracy:
    """Running top-1/top-k accuracy with optional per-question-type
    breakdown. Feed it counts (from ``topk_correct``) or raw arrays."""

    def __init__(self, top_k: int = 5):
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self.correct_top1 = 0
        self.correct_topk = 0
        self.total = 0
        self.type_correct: Dict[str, int] = {}
        self.type_total: Dict[str, int] = {}

    def update(self, logits, targets,
               question_types: Optional[Sequence[str]] = None) -> None:
        logits = np.asarray(logits)
        targets = np.asarray(targets)
        c1, ck = topk_correct(torch.from_numpy(logits), torch.from_numpy(targets),
                              self.top_k)
        self.correct_top1 += int(c1)
        self.correct_topk += int(ck)
        self.total += int(targets.shape[0])
        if question_types is not None:
            preds = np.argmax(logits, axis=-1)
            for qt, p, t in zip(question_types, preds, targets):
                self.type_total[qt] = self.type_total.get(qt, 0) + 1
                if p == t:
                    self.type_correct[qt] = self.type_correct.get(qt, 0) + 1

    def update_counts(self, top1_correct: int, topk_correct_: int, n: int) -> None:
        """Update from counts reduced on the device."""
        self.correct_top1 += int(top1_correct)
        self.correct_topk += int(topk_correct_)
        self.total += int(n)

    def compute(self) -> Dict[str, float]:
        if self.total == 0:
            return {"top1_accuracy": 0.0, f"top{self.top_k}_accuracy": 0.0}
        out = {
            "top1_accuracy": self.correct_top1 / self.total,
            f"top{self.top_k}_accuracy": self.correct_topk / self.total,
        }
        for qt in self.type_total:
            out[f"type_{qt}_accuracy"] = self.type_correct.get(qt, 0) / self.type_total[qt]
        return out


class VQAChallengeAccuracy:
    """Official VQA challenge soft accuracy accumulator."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.score_sum = 0.0
        self.total = 0

    def update(self, pred_idx, annotator_answer_idx) -> None:
        scores = vqa_soft_scores(torch.as_tensor(np.asarray(pred_idx)),
                                 torch.as_tensor(np.asarray(annotator_answer_idx)))
        self.score_sum += float(scores.sum())
        self.total += int(np.asarray(pred_idx).shape[0])

    def compute(self) -> float:
        return self.score_sum / self.total if self.total else 0.0


class AverageMeter:
    """Running average."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class MetricsLogger:
    """Epoch-keyed metric history with best-lookup and a dict round-trip
    for checkpoints; ``save`` writes the reference's
    ``training_history.json`` format."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}
        self.epochs: List[int] = []

    def log(self, epoch: int, metrics: Dict[str, float]) -> None:
        if epoch not in self.epochs:
            self.epochs.append(epoch)
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def get_best(self, metric: str, mode: str = "max"):
        vals = self.history.get(metric, [])
        if not vals:
            return None, None
        fn = max if mode == "max" else min
        best = fn(vals)
        idx = vals.index(best)
        epoch = self.epochs[idx] if idx < len(self.epochs) else idx
        return best, epoch

    def to_dict(self) -> dict:
        return {"history": self.history, "epochs": self.epochs}

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsLogger":
        logger = cls()
        logger.history = {k: list(v) for k, v in d.get("history", {}).items()}
        logger.epochs = list(d.get("epochs", []))
        return logger

    def save(self, filepath: str) -> None:
        d = os.path.dirname(filepath)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(filepath, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2)
