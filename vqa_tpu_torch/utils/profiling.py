"""Spans and counters, tracing, step timing and benchmark inputs.

Counterpart of ``vqa_tpu/utils/profiling.py``:

- :func:`annotate`: a span, kept in memory in a fixed ring per name
  (start and end on ``time.perf_counter_ns``, the span open around it on
  its thread, one small integer ``value``), read back with :func:`spans`;
  while a profiler runs, also a ``torch.profiler.record_function`` range,
  so that the span sits on the profiler's own timeline;
  :func:`count` records a value alone, as a span of no length;
  :func:`watch_gc` records the interpreter's collections the same way;
- :func:`step_annotation`: a step-scoped range on a profiler's timeline;
- :class:`Profiler` / :func:`maybe_trace`: a ``torch.profiler`` trace of
  a window of work, written to a directory as a Chrome trace
  (TensorBoard's profile plugin and Perfetto read it), spans included;
- :class:`StepTimer`: per-step wall time fenced on the device
  (``torch.cuda.synchronize`` for results on the card), with p50/p99 and
  items/s; :func:`percentile_summary`;
- :func:`device_synthetic_inputs`: random model inputs generated on the
  device, never staged through the host.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd import _profiler_enabled

__all__ = [
    "annotate",
    "spans",
    "watch_gc",
    "step_annotation",
    "Profiler",
    "StepTimer",
    "percentile_summary",
    "device_synthetic_inputs",
]

# records kept per name: three times the bucket dispatches of a 20 s window
# of batch scoring (~580 a second on the H100)
RING_SIZE = 1 << 16


class Span(NamedTuple):
    """One finished span. ``seq`` counts the name's spans from 0 in the
    order they ended; ``id`` is unique in the process, and ``parent`` is the
    ``id`` of the span open around it on its thread (0 where none was)."""

    seq: int
    id: int
    parent: int
    start_ns: int
    end_ns: int
    value: int


class _Ring:
    __slots__ = ("name", "slots", "records")

    def __init__(self, name: str):
        self.name = name
        self.slots = itertools.count()   # next() is atomic: no lock on the hot path
        self.records: List[Optional[tuple]] = [None] * RING_SIZE


_rings: Dict[str, _Ring] = {}
_rings_lock = threading.Lock()
_ids = itertools.count(1)


class _Open(threading.local):
    span = 0   # the id of the innermost span open on this thread


_open = _Open()
_now = time.perf_counter_ns


def _ring(name: str) -> _Ring:
    """The ring of ``name``, made on its first span."""
    with _rings_lock:
        if name not in _rings:
            _rings[name] = _Ring(name)
        return _rings[name]


class annotate:
    """A span named ``name``, as a context manager; set ``.value`` inside it
    to record a small integer with it. Inside it, ``.id`` is the id its
    record and its children's ``parent`` will hold, and ``phase`` begins
    child spans one after another; set ``.phase_value`` during a phase to
    record a small integer with the phase (0 where it is not set).

    On exit it writes one record into the name's ring of ``RING_SIZE``
    (the oldest is overwritten), from any thread without a lock. While a
    profiler runs it is also a ``record_function`` range, whose interval
    is the profiler's own. Host time (PERF.md §3 has the card's host's
    figures): ~1.3 us a span with no profiler in a tight loop, several
    times that in a hot path whose work has left the host's caches cold;
    under a profiler, the range's ~12 us besides."""

    __slots__ = ("_ring", "value", "id", "_parent", "_start", "_range", "_phase",
                 "phase_value")

    def __init__(self, name: str, value: int = 0):
        self._ring = _rings.get(name) or _ring(name)
        self.value = value
        self._phase = None
        self.phase_value = 0

    def __enter__(self) -> "annotate":
        self.id = next(_ids)
        self._parent = _open.span
        _open.span = self.id
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self._ring.name)
            self._range.__enter__()
        self._start = _now()
        return self

    def phase(self, name: str) -> None:
        """End the current phase, if one is open, and begin a child span
        ``name`` that lasts until the next ``phase`` or this span's end.

        One call where a nested ``annotate`` takes three (a hot path's
        consecutive steps). A phase is a range on a profiler's timeline
        where this span is one; spans opened during a phase take this
        span, not the phase, as their parent."""
        now = _now()
        if self._phase is not None:
            self._end_phase(now)
        ring = _rings.get(name) or _ring(name)
        self.phase_value = 0
        if self._range is None:
            self._phase = (ring, next(_ids), now, None)
        else:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._phase = (ring, next(_ids), now, rf)

    def _end_phase(self, end: int) -> None:
        ring, id_, start, rf = self._phase
        self._phase = None
        if rf is not None:
            rf.__exit__(None, None, None)
        seq = next(ring.slots)
        ring.records[seq % RING_SIZE] = (seq, id_, self.id, start, end, self.phase_value)

    def __exit__(self, *exc) -> bool:
        end = _now()
        if self._phase is not None:
            self._end_phase(end)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open.span = self._parent
        ring = self._ring
        seq = next(ring.slots)
        ring.records[seq % RING_SIZE] = (seq, self.id, self._parent, self._start, end,
                                         self.value)
        return False


def count(name: str, value: int) -> None:
    """Record ``value`` under ``name`` as a span of no length, ending now, in
    the span open on this thread: a counter read back with :func:`spans`."""
    ring = _rings.get(name) or _ring(name)
    now = _now()
    seq = next(ring.slots)
    ring.records[seq % RING_SIZE] = (seq, next(_ids), _open.span, now, now, value)


def spans(name: str) -> Tuple[List[Span], int]:
    """The records of ``name`` still in its ring, in the order their spans
    ended, and how many it ever recorded (more than the records where the
    ring has wrapped)."""
    ring = _rings.get(name)
    if ring is None:
        return [], 0
    records = sorted(r for r in list(ring.records) if r is not None)
    return [Span(*r) for r in records], (records[-1][0] + 1 if records else 0)


_gc_span: Optional[annotate] = None


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    global _gc_span
    if phase == "start":
        _gc_span = annotate("python.gc", info["generation"]).__enter__()
    elif _gc_span is not None:
        span, _gc_span = _gc_span, None
        span.__exit__(None, None, None)


def watch_gc() -> None:
    """Record each collection of the interpreter's cyclic garbage collector
    as a ``python.gc`` span whose value is the generation collected. Once
    per process; later calls do nothing. (One collection runs at a time, in
    the thread that set it off.)"""
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


_NO_RANGE = contextlib.nullcontext()


def step_annotation(name: str, step: int):
    """Step-scoped range (``train#12``) on a running profiler's timeline;
    nothing is recorded, or paid, with no profiler on."""
    if _profiler_enabled():
        return torch.profiler.record_function(f"{name}#{step}")
    return _NO_RANGE


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


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]):
    """Trace the enclosed work into ``logdir/trace.json`` when ``logdir`` is
    set; otherwise do nothing."""
    if not logdir:
        yield
        return
    with Profiler(logdir):
        yield


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
