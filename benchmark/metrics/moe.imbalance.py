"""moe.imbalance: the most rows one held expert got in one MoE layer of a
forward (the program's `moe.route_max` counter), over the mean rows per
held expert per layer (`moe.rows_per_expert`), both the mean over the
measured window's dispatches; 1 where the held experts share the rows
evenly. None where the program records no such counter."""

from benchmark.harness.routes import mean
from benchmark.harness.spec import reader


def read(rec):
    per_expert = reader("moe.rows_per_expert")(rec)
    most = mean(rec, "moe.route_max")
    return most / per_expert if per_expert and most is not None else None
