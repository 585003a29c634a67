"""forward.device_ms: device ms of kernels per bucket forward in the traced
sub-window: the kernels' summed profiler time (copies and sets left out)
over the forwards the sub-window dispatched."""


def read(rec):
    if not rec.trace or not rec.trace_counts.get("forwards"):
        return None
    kernels = sum(t for name, t in rec.trace["by_name"].items()
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels * 1e3 / rec.trace_counts["forwards"]
