"""moe.rows_per_expert: the rows routed to each held expert in each MoE
layer of a forward, the mean over the measured window's dispatches: the
value of the program's `moe.route` counter (the rows routed to the held
experts over every MoE layer of one dispatch, written by its CUDA graph on
the device and read at the call's fetch) over the held experts times the
MoE layers. None where the program records no such counter
(`harness/routes.py`)."""

from benchmark.costs.decoder_flops import moe_layers
from benchmark.harness.routes import mean


def read(rec):
    rows = mean(rec, "moe.route")
    if rows is None:
        return None
    cfg = rec.cell.model
    return rows / (cfg["experts_held"] * moe_layers(cfg))
