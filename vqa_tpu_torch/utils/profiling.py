"""Tracing and step timing for the trainer.

Counterpart of the parts of ``vqa_tpu/utils/profiling.py`` that the
trainer uses:

- :func:`annotate` / :func:`step_annotation`: named ranges
  (``torch.profiler.record_function``) that show on a profiler timeline;
- :func:`maybe_trace`: a ``torch.profiler`` trace of a window of work,
  written to a directory as a Chrome trace (TensorBoard's profile plugin
  and Perfetto read it);
- :class:`StepTimer`: per-step wall time fenced on the device
  (``torch.cuda.synchronize`` for results on the card), with p50/p99 and
  items/s; :func:`percentile_summary`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["annotate", "step_annotation", "maybe_trace", "StepTimer", "percentile_summary"]


def annotate(name: str):
    """Named range on the profiler timeline; outside a trace it costs a
    few microseconds."""
    return torch.profiler.record_function(name)


def step_annotation(name: str, step: int):
    """Step-scoped range (``train#12``)."""
    return torch.profiler.record_function(f"{name}#{step}")


def percentile_summary(values_ms: List[float]) -> Dict[str, float]:
    """mean/p50/p99/min/max over millisecond samples."""
    if not values_ms:
        return {"count": 0}
    arr = np.asarray(values_ms, dtype=np.float64)
    return {
        "count": int(arr.size),
        "mean_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p99_ms": float(np.percentile(arr, 99)),
        "min_ms": float(arr.min()),
        "max_ms": float(arr.max()),
    }


def _on_card(result: Any) -> set:
    """The CUDA devices of a tensor or of a dict's tensors."""
    leaves = result.values() if isinstance(result, dict) else [result]
    return {t.device for t in leaves if isinstance(t, torch.Tensor) and t.device.type == "cuda"}


class StepTimer:
    """Per-step timer fenced on the device.

    Usage::

        timer = StepTimer()
        for batch in loader:
            with timer.step(items=len(batch)) as s:
                s.result = train_step(state, batch)   # fenced on exit

    On exit the timer synchronizes every CUDA device that holds
    ``s.result`` (a tensor, or a dict of them, as a train step returns;
    nothing is fenced when no result was assigned), so
    the interval covers the device's work, not only its launch."""

    class _Step:
        __slots__ = ("result",)

        def __init__(self):
            self.result: Any = None

    def __init__(self, max_samples: int = 100_000):
        self._samples: List[tuple] = []
        self._max = max_samples

    @contextlib.contextmanager
    def step(self, items: int = 1):
        s = StepTimer._Step()
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            if s.result is not None:
                for dev in _on_card(s.result):
                    torch.cuda.synchronize(dev)
            self._samples.append(((time.perf_counter() - t0) * 1000.0, items))
            if len(self._samples) > self._max:
                self._samples = self._samples[-self._max // 2:]

    def reset(self) -> None:
        self._samples = []

    def summary(self) -> Dict[str, float]:
        out = percentile_summary([t for t, _ in self._samples])
        total_s = sum(t for t, _ in self._samples) / 1000.0
        if total_s > 0:
            out["items_per_sec"] = float(sum(i for _, i in self._samples) / total_s)
        return out


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]):
    """Trace the enclosed work into ``logdir/trace.json`` (CPU, and CUDA
    when a card is present) when ``logdir`` is set; otherwise do nothing."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
