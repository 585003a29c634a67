"""engine.fetch_ms_per_call: host ms of the program's `engine.fetch` span
(`predict_probs_from_pixels` copying every chunk's probabilities to the
host and joining them: the host waits there for the card) per call, the
mean over the measured window's calls (`harness/program_spans.py`)."""

from benchmark.harness.program_spans import calls, ms


def read(rec):
    got = calls(rec)
    return sum(ms(r) for r in got) / len(got) if got else None
