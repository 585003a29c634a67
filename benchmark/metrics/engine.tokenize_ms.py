"""engine.tokenize_ms: host ms of the program's `engine.tokenize` span (the
engine's `_padded`: the questions encoded, the chunk padded to its bucket)
inside each window dispatch, the mean over the measured window's
dispatches (`harness/program_spans.py`)."""

from benchmark.harness.program_spans import child_ms_per_dispatch


def read(rec):
    return child_ms_per_dispatch(rec, "engine.tokenize")
