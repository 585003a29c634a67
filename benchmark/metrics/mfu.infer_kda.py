"""mfu.infer_kda: the whole step's share of the H100's bf16 peak for the
hybrid decoder model: the operations of one pair at the configuration's
widths (`costs/kimi_linear_flops.py`, the routed experts at the expected
rows, the KDA core's update included) times the pairs answered in the
measured window, over the window's seconds times 989 TFLOP/s. Host clock
over the whole window, so it is `infer_pairs_per_s` times a constant of
the configuration."""

from benchmark.costs.kimi_linear_flops import forward_flops
from benchmark.costs.peaks import BF16_FLOP_PER_S


def read(rec):
    if not rec.counts.get("pairs"):
        return None
    ops = forward_flops(rec.cell.model)["total"] * rec.counts["pairs"]
    return 100.0 * ops / (rec.window_s * BF16_FLOP_PER_S)
