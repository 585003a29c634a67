"""engine.stage_ms: host ms of the program's `engine.stage` span (the
pinned host blocks allocated and the chunk copied into them, for every
replica) inside each window dispatch, the mean over the measured window's
dispatches (`harness/program_spans.py`)."""

from benchmark.harness.program_spans import child_ms_per_dispatch


def read(rec):
    return child_ms_per_dispatch(rec, "engine.stage")
