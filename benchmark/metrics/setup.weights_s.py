"""setup.weights_s: seconds of the program's `engine.load.weights` span:
the checkpoint read, the model built (`setup.init_s` inside), the state
loaded and moved to the card (`harness/program_spans.py`)."""

from benchmark.harness.program_spans import last


def read(rec):
    span = last("engine.load.weights")
    return (span.end_ns - span.start_ns) / 1e9 if span else None
