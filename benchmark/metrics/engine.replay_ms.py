"""engine.replay_ms: host ms of the program's `engine.replay` span (the
replay lock, the copy into the graph's static inputs, the replay, the copy
of its output and the launch-count update) inside each window dispatch,
the mean over the measured window's dispatches
(`harness/program_spans.py`)."""

from benchmark.harness.program_spans import child_ms_per_dispatch


def read(rec):
    return child_ms_per_dispatch(rec, "engine.replay")
