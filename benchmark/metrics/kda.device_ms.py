"""kda.device_ms: device ms per forward of the linear attention core in the
traced sub-window: the port's KDA kernels (`costs/kimi_linear_flops.py:
KDA_KERNELS`, matched whole by function name, `harness/trace.py:
kernel_base`), over the forwards the sub-window dispatched. Read only where
each launched its count per KDA layer per forward; otherwise not read, and
a note says how often each did (a program without the kernels launches
them 0 times)."""

from benchmark.costs.kimi_linear_flops import KDA_KERNELS, kda_layers
from benchmark.harness.trace import kernel_time


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    per_forward = kda_layers(rec.cell.model) * forwards
    found = {name: kernel_time(rec.trace, (name,)) for name in KDA_KERNELS}
    off = [f"{name} ({launches} launches, {KDA_KERNELS[name] * per_forward} expected)"
           for name, (_, launches) in found.items()
           if launches != KDA_KERNELS[name] * per_forward]
    if off:
        rec.notes.append("kda.device_ms not read: " + "; ".join(off))
        return None
    return sum(s for s, _ in found.values()) * 1e3 / forwards
