"""engine.host_ms_per_dispatch: host ms of each `dispatch_probs_from_pixels`
call (pad, tokenize, stage in pinned memory, copy in, replay, copy out;
one bucket chunk), the mean over the window. Read from the benchmark's
span around that call."""


def read(rec):
    times = rec.spans.get("engine.dispatch")
    return sum(times) / len(times) if times else None
