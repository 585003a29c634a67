"""moe.experts_ms: device ms per forward of the routed experts in the
traced sub-window: the permute, both grouped GEMMs (with their set-up
kernel), the SwiGLU and the unpermute of every MoE layer, the kernels
`costs/decoder_flops.py` names (`ROUTED_KERNELS`, matched whole by
function name; `ROUTED_SWIGLU`, by its routed form's template argument;
`GROUPED_GEMM`, by the marks in its mangled name), over
the forwards the sub-window dispatched. Where one of them did not launch
its number of times per MoE layer per forward, it is not read, and a note
says which."""

from benchmark.costs.decoder_flops import GROUPED_GEMM, ROUTED_KERNELS, ROUTED_SWIGLU, moe_layers
from benchmark.harness.trace import kernel_time


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    per_forward = moe_layers(rec.cell.model) * forwards
    found = {name: kernel_time(rec.trace, (name,)) for name in ROUTED_KERNELS}
    marks, gemm_per_layer = GROUPED_GEMM
    mark, swiglu_per_layer = ROUTED_SWIGLU
    for what, names in (("grouped GEMM", [n for n in rec.trace["by_name"]
                                          if all(m in n for m in marks)]),
                        ("routed SwiGLU", [n for n in rec.trace["by_name"] if mark in n])):
        found[what] = (sum(rec.trace["by_name"][n] for n in names),
                       sum(rec.trace["launches"][n] for n in names))
    want = dict(ROUTED_KERNELS, **{"grouped GEMM": gemm_per_layer,
                                   "routed SwiGLU": swiglu_per_layer})
    off = [f"{name} ({launches} launches, {want[name] * per_forward} expected)"
           for name, (_, launches) in found.items() if launches != want[name] * per_forward]
    if off:
        rec.notes.append("moe.experts_ms not read: " + "; ".join(off))
        return None
    return sum(s for s, _ in found.values()) * 1e3 / forwards
