"""mla.device_ms: device ms per forward of the hybrid decoder's softmax
attention core in the traced sub-window: the port's `mla_attention_bf16`
kernel (matched whole by its function name, `harness/trace.py:
kernel_base`), over the forwards the sub-window dispatched. The kernel runs
in the layers outside `kda_layers`, so it is read only where it launched
once per such layer per forward; otherwise not read, and a note says how
often it did (a program without the hybrid decoder launches it 0 times
here)."""

from benchmark.harness.trace import kernel_time

KERNEL = "mla_attention_bf16"


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    seconds, launches = kernel_time(rec.trace, (KERNEL,))
    cfg = rec.cell.model
    want = (cfg["decoder_layers"] - len(cfg["kda_layers"])) * forwards
    if launches != want:
        rec.notes.append(f"mla.device_ms not read: {KERNEL} ({launches} launches, {want} "
                         f"expected)")
        return None
    return seconds * 1e3 / forwards
