"""The program's routing counters of the measured window.

The engine records, per dispatch of a model with routed experts, the
counters `moe.route` (the rows routed to the held experts over every MoE
layer) and `moe.route_max` (the most rows one held expert got in one
layer), at the fetch of the dispatch's call, in the order of the
dispatches. The warm-up's come first, then the measured window's
(`harness/program_spans.py` finds `engine.dispatch`'s the same way).
"""

from __future__ import annotations

from typing import List, Optional

from benchmark.harness.program_spans import window


def counters(rec, name: str) -> Optional[List]:
    """The measured window's records of `name`, one per dispatch, or None."""
    p = rec.cell.traffic
    per_call = -(-p["call_pairs"] // p["bucket"])
    return window(name, p["warm_calls"] * per_call, rec.counts.get("forwards"))


def mean(rec, name: str) -> Optional[float]:
    got = counters(rec, name)
    return sum(r.value for r in got) / len(got) if got else None
