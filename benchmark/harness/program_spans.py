"""The program's own spans, for the readers of `program_span` metrics.

`vqa_tpu_torch.utils.profiling` keeps every span the port records in a
ring per name (`spans(name)`: the records still held, in the order they
ended, and the total ever recorded). A run of `kinds/infer_pixels.py`
leaves them in this process, and its records are found by position:

- `engine.dispatch`: the first `warm_calls * ceil(call_pairs / bucket)`
  records are the warm-up's, the next `counts["forwards"]` the measured
  window's; the traced sub-window's follow;
- `engine.fetch`: `warm_calls`, then `counts["calls"]`;
- a dispatch's children (`engine.tokenize`, `engine.stage`,
  `engine.replay`) by their `parent`, the dispatch's `id`;
- set-up spans: the run loads one engine, so the last record of a name.

Each function returns None where there is nothing to read: a program
without the recorder (no `spans`), fewer records than the window needs,
or a ring that has wrapped past the window.
"""

from __future__ import annotations

from typing import Callable, List, Optional


def recorder() -> Optional[Callable]:
    """The program's `spans`, or None where the program records none."""
    try:
        from vqa_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "spans", None)


def ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def window(name: str, skip: int, count) -> Optional[List]:
    """Records `skip` to `skip + count - 1` of `name`, or None."""
    read = recorder()
    if read is None or not count:
        return None
    records, total = read(name)
    count = int(count)
    if total < skip + count:
        return None
    got = [r for r in records if skip <= r.seq < skip + count]
    return got if len(got) == count else None


def dispatches(rec) -> Optional[List]:
    """The measured window's `engine.dispatch` records."""
    p = rec.cell.traffic
    per_call = -(-p["call_pairs"] // p["bucket"])
    return window("engine.dispatch", p["warm_calls"] * per_call, rec.counts.get("forwards"))


def calls(rec) -> Optional[List]:
    """The measured window's `engine.fetch` records, one a call."""
    return window("engine.fetch", rec.cell.traffic["warm_calls"], rec.counts.get("calls"))


def child_ms_per_dispatch(rec, name: str) -> Optional[float]:
    """Host ms of `name` inside each window dispatch, the mean; None where
    a window dispatch has no such child left in the ring."""
    ds = dispatches(rec)
    if ds is None:
        return None
    ids = {d.id for d in ds}
    kids = [r for r in recorder()(name)[0] if r.parent in ids]
    if {r.parent for r in kids} != ids:
        return None
    return sum(ms(r) for r in kids) / len(ds)


def last(name: str):
    """The last record of `name`, or None."""
    read = recorder()
    if read is None:
        return None
    records, _ = read(name)
    return records[-1] if records else None
