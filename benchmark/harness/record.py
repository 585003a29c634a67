"""What a run leaves for the metric readers and the result line."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Check:
    """One number compared with the plain reference, beside its limit
    (None while no limit is set: the run is then not correct)."""

    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value <= self.limit


@dataclass
class Record:
    cell: object                      # spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0             # the measured window, host clock
    attempted: int = 0
    failed: int = 0
    counts: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)  # ms each
    trace: Optional[dict] = None      # harness/trace.py summary of the traced sub-window
    trace_idle: Optional[dict] = None  # idle gaps by host annotation, where `trace` has none
    trace_counts: Dict[str, float] = field(default_factory=dict)
    trace_reason: str = ""            # why `trace` is None, where it is
    memory_peak_bytes: int = 0
    checks: Dict[str, Check] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)  # printed before the result line

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks.values())

    def span(self, name: str):
        """A callable wrapper factory: `record.span(name)(fn)` appends each
        call's host milliseconds to `spans[name]`."""
        times = self.spans.setdefault(name, [])

        def wrap(fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    times.append((time.perf_counter() - t0) * 1e3)
            return timed
        return wrap


@contextlib.contextmanager
def annotated(name: str, on: bool):
    """A `bench.<name>` host annotation in the profiler's trace when `on`."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function("bench." + name):
        yield
