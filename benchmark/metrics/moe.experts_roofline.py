"""moe.experts_roofline: the routed experts against their roofline: the
bound of one forward's routed path (`costs/decoder_flops.py:
routed_bound_s`, at the bf16 peak and 3.35 TB/s, for the forward's tokens
and the rows the program routed to the held experts, `moe.route`'s mean
over the measured window) over its device time (`moe.experts_ms`), in %."""

from benchmark.costs.decoder_flops import positions, routed_bound_s
from benchmark.harness.routes import mean
from benchmark.harness.spec import reader


def read(rec):
    spent_ms = reader("moe.experts_ms")(rec)
    rows = mean(rec, "moe.route")
    if not spent_ms or rows is None:
        return None
    tokens = rec.cell.traffic["bucket"] * positions(rec.cell.model)
    return 100.0 * routed_bound_s(rec.cell.model, tokens, rows) * 1e3 / spent_ms
