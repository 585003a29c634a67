"""engine.starved_share: the share of the measured window's dispatches
that found the card drained, in %: the value of the program's
`engine.dispatch` span is 1 where, when the dispatch began, the card had
finished every earlier dispatch (an event recorded after each replay's copy
out). The first dispatch of each call follows a fetch, so with one caller
and 8 dispatches a call it reads at least 12.5% (`harness/program_spans.py`)."""

from benchmark.harness.program_spans import dispatches


def read(rec):
    got = dispatches(rec)
    return 100.0 * sum(r.value == 1 for r in got) / len(got) if got else None
