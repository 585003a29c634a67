"""TensorBoard scalar logging for ``--log-dir``.

Counterpart of ``vqa_tpu/utils/tb.py``: per-epoch train/val loss, top-1/
top-5 accuracy and learning rate as TensorBoard events through
``tensorboardX``, else ``torch.utils.tensorboard``, else a JSONL scalar log
(``scalars.jsonl``), so training never fails for a missing viewer library.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Optional


class ScalarWriter:
    """Per-epoch scalar logger: TensorBoard events when available, JSONL
    (one ``{"step": N, "tag": ..., "value": ...}`` per line) otherwise.
    ``backend`` names the path in use."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._writer = None
        self._jsonl = None
        self.backend = "jsonl"
        for mod, attr in (
            ("tensorboardX", "SummaryWriter"),
            ("torch.utils.tensorboard", "SummaryWriter"),
        ):
            try:
                cls = getattr(importlib.import_module(mod), attr)
                self._writer = cls(log_dir)
                self.backend = mod
                break
            except Exception:  # a viewer library that fails to load is skipped
                continue
        if self._writer is None:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for tag, value in scalars.items():
            v = float(value)
            if self._writer is not None:
                self._writer.add_scalar(tag, v, step)
            else:
                self._jsonl.write(json.dumps({"step": int(step), "tag": tag, "value": v}) + "\n")
        if self._writer is not None and hasattr(self._writer, "flush"):
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._jsonl is not None:
            self._jsonl.close()


def maybe_scalar_writer(log_dir: Optional[str]) -> Optional[ScalarWriter]:
    """No log_dir → no writer."""
    return ScalarWriter(log_dir) if log_dir else None
