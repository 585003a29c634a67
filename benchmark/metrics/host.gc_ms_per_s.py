"""host.gc_ms_per_s: ms of the interpreter's garbage collections (the
program's `python.gc` spans, recorded from the engine's load on) that
start inside the measured window, per second of it; the window runs from
its first dispatch's start to its last dispatch's end
(`harness/program_spans.py`)."""

from benchmark.harness.program_spans import dispatches, ms, recorder


def read(rec):
    ds = dispatches(rec)
    if ds is None:
        return None
    t0, t1 = ds[0].start_ns, ds[-1].end_ns
    records, total = recorder()("python.gc")
    if total > len(records) and records[0].start_ns > t0:
        return None  # the ring has wrapped past the window's start
    spent = sum(ms(r) for r in records if t0 <= r.start_ns < t1)
    return spent / ((t1 - t0) / 1e9)
