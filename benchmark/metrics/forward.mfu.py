"""forward.mfu: the model's share of the H100's bf16 peak while its kernels
run: the operations of one bucket forward at the configuration's widths
(`costs/flops.py`, per pair, times the bucket) over the kernels' device
time per bucket forward (`forward.device_ms`) times 989 TFLOP/s, in %.
Device time only, so the host's dispatch does not move it."""

from benchmark.costs.flops import forward_flops
from benchmark.costs.peaks import BF16_FLOP_PER_S
from benchmark.harness.spec import reader


def read(rec):
    device_ms = reader("forward.device_ms")(rec)
    if not device_ms:
        return None
    ops = forward_flops(rec.cell.model)["total"] * rec.cell.traffic["bucket"]
    return 100.0 * ops / (device_ms * 1e-3 * BF16_FLOP_PER_S)
