"""moe.router_ms: device ms per forward of the MoE layers' routing in the
traced sub-window: the port's `moe_route_bf16` (logits, scores, choices
and weights) and `moe_plan` (the route plan) kernels, each matched whole by
its function name (`harness/trace.py:kernel_base`), over the forwards the
sub-window dispatched. Read only where each launched once per MoE layer
per forward; otherwise not read, and a note says how often each did (a
program without the kernels, as before they were written, launches them 0
times)."""

from benchmark.costs.decoder_flops import moe_layers
from benchmark.harness.trace import kernel_time

KERNELS = ("moe_route_bf16", "moe_plan")


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    want = moe_layers(rec.cell.model) * forwards
    found = {name: kernel_time(rec.trace, (name,)) for name in KERNELS}
    off = [f"{name} ({launches} launches, {want} expected)"
           for name, (_, launches) in found.items() if launches != want]
    if off:
        rec.notes.append("moe.router_ms not read: " + "; ".join(off))
        return None
    return sum(s for s, _ in found.values()) * 1e3 / forwards
