"""Tracing, step timing and benchmark inputs.

Counterpart of ``vqa_tpu/utils/profiling.py``:

- :func:`annotate` / :func:`step_annotation`: named ranges
  (``torch.profiler.record_function``) that show on a profiler timeline;
- :func:`start_trace` / :func:`stop_trace` / :class:`Profiler` /
  :func:`maybe_trace`: a ``torch.profiler`` trace of a window of work,
  written to a directory as a Chrome trace (TensorBoard's profile plugin
  and Perfetto read it);
- :class:`StepTimer`: per-step wall time fenced on the device
  (``torch.cuda.synchronize`` for results on the card), with p50/p99 and
  items/s; :func:`percentile_summary`;
- :func:`time_chained`: best-of-reps seconds per call over a chain of
  dispatches, fenced by one scalar device-to-host fetch;
- :func:`device_synthetic_inputs`: random model inputs generated on the
  device, never staged through the host.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "annotate",
    "step_annotation",
    "start_trace",
    "stop_trace",
    "Profiler",
    "StepTimer",
    "percentile_summary",
    "time_chained",
    "device_synthetic_inputs",
]


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


class Profiler:
    """Trace a window of work (CPU, and CUDA when a card is present) into
    ``logdir/trace.json``.

    >>> with Profiler("/tmp/trace"):
    ...     out = train_step(...)
    ...     torch.cuda.synchronize()
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.logdir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


_active: Optional[Profiler] = None
_active_lock = threading.Lock()


def start_trace(logdir: str) -> None:
    """Begin a trace into ``logdir``; one at a time per process."""
    global _active
    with _active_lock:
        if _active is not None:
            raise RuntimeError(f"a trace into {_active.logdir} is already running")
        prof = Profiler(logdir)
        prof.start()
        _active = prof


def stop_trace() -> None:
    """End the trace ``start_trace`` began and write it."""
    global _active
    with _active_lock:
        if _active is None:
            raise RuntimeError("no trace is running")
        prof, _active = _active, None
    prof.stop()


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]):
    """Trace the enclosed work into ``logdir/trace.json`` when ``logdir`` is
    set; otherwise do nothing."""
    if not logdir:
        yield
        return
    with Profiler(logdir):
        yield


def time_chained(fn, *args, reps: int = 3, chain: int = 10) -> float:
    """Best-of-``reps`` seconds per call over ``chain`` back-to-back calls,
    fenced by one device-to-host fetch of a scalar output.

    Launches return before the card finishes; the fetch of the last call's
    scalar (``float()``) waits for every call queued before it. ``fn`` must
    return a scalar tensor, or a tuple whose first element is one.
    Best-of-``reps`` filters host noise: the number is a best case."""
    best = float("inf")
    for _ in range(reps):
        r = None
        t0 = time.perf_counter()
        for _ in range(chain):
            r = fn(*args)
        float(r[0] if isinstance(r, tuple) else r)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best


def device_synthetic_inputs(
    batch: int,
    *,
    image_size: int = 224,
    qlen: int = 20,
    vocab_size: int = 10000,
    num_answers: int = 1000,
    channels: int = 3,
    pixels: str = "f32",
    seed: int = 0,
    device="cuda",
):
    """Synthetic ``(images, token_ids, mask, labels)`` generated on
    ``device`` (the card unless the CPU is asked for) from a
    ``torch.Generator`` there, seeded with ``seed``.

    images: [B, S, S, channels], f32 standard normal (``pixels="f32"``, the
    distribution after normalize) or uint8 uniform over 0..255 (``"u8"``,
    raw pixels for paths that normalize or augment on the device);
    token_ids: int64 in [4, vocab_size) (no special tokens); mask: int64
    ones; labels: int64 in [0, num_answers). The shapes, dtypes and ranges
    are the JAX function's (its ids, mask and labels are int32); the values
    are not: torch's generators do not draw JAX's PRNG bits.
    """
    from vqa_tpu_torch.models.vqa_model import resolve_device

    if pixels not in ("f32", "u8"):
        raise ValueError(f"pixels must be 'f32' or 'u8', got {pixels!r}")
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, image_size, image_size, channels)
    if pixels == "u8":
        images = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
    else:
        images = torch.randn(shape, generator=g, device=device)
    ids = torch.randint(4, vocab_size, (batch, qlen), generator=g, device=device)
    mask = torch.ones((batch, qlen), dtype=torch.int64, device=device)
    labels = torch.randint(0, num_answers, (batch,), generator=g, device=device)
    return images, ids, mask, labels
