"""kda.roofline: the linear attention core against its roofline: the bound
of one forward's KDA cores (`costs/kimi_linear_flops.py:kda_bound_s`, the
larger of their bytes at 3.35 TB/s and their operations at the bf16 peak,
for the forward's tokens) over their device time (`kda.device_ms`), in %."""

from benchmark.costs.decoder_flops import positions
from benchmark.costs.kimi_linear_flops import kda_bound_s
from benchmark.harness.spec import reader


def read(rec):
    spent_ms = reader("kda.device_ms")(rec)
    if not spent_ms:
        return None
    tokens = rec.cell.traffic["bucket"] * positions(rec.cell.model)
    return 100.0 * kda_bound_s(rec.cell.model, tokens) * 1e3 / spent_ms
