"""kernels_roofline: the port's own kernels (stem, SE, cross-attention)
against their roofline in the traced sub-window: the sum of their bounds
(`costs/kernels.py`: bytes at 3.35 TB/s or operations at the form's peak)
over the sum of their profiler device times, in %. Kernels are matched by
their function's name, whole. Where a family the configuration runs is
missing from the trace, or its launches are not the expected number per
forward, the share is not read, and a note names the family."""

from benchmark.costs.kernels import forward_bounds
from benchmark.harness.trace import kernel_time


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    cell = rec.cell
    bound = spent = 0.0
    off = []
    for family, fam in forward_bounds(cell.model, cell.traffic["bucket"], cell.dtype).items():
        seconds, launches = kernel_time(rec.trace, fam["names"])
        if launches != fam["launches"] * forwards:
            off.append(f"{family} ({launches} launches of {'/'.join(fam['names'])}, "
                       f"{fam['launches'] * forwards} expected)")
        bound += fam["bound_s"] * forwards
        spent += seconds
    if off:
        rec.notes.append("kernels_roofline not read: " + "; ".join(off))
        return None
    return 100.0 * bound / spent
