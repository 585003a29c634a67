"""idle.infer: the share of the measured window in which the device had no
operation to run, in %: 1 - (device-busy seconds per bucket forward, from
the traced sub-window: the union of the profiler's device intervals over
the forwards it dispatched) x (the forwards the window dispatched) / (the
window's seconds). The traced sub-window's own idle share (`busy_s`,
`window_s`) reads higher: even with device activity only, the profiler
slows the host's dispatch, which the device waits on."""


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards or not rec.counts.get("forwards"):
        return None
    busy_s = rec.trace["busy_s"] / forwards * rec.counts["forwards"]
    return 100.0 * (1.0 - busy_s / rec.window_s)
