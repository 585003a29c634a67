"""setup.init_s: seconds of the program's `model.init` span inside the
engine's `engine.load.weights`: the seeded random initialisation of the
model that the checkpoint's state then overwrites
(`harness/program_spans.py`)."""

from benchmark.harness.program_spans import last, recorder


def read(rec):
    weights = last("engine.load.weights")
    if weights is None:
        return None
    inside = [r for r in recorder()("model.init")[0] if r.parent == weights.id]
    return sum((r.end_ns - r.start_ns) for r in inside) / 1e9 if inside else None
