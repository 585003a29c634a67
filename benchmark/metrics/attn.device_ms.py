"""attn.device_ms: device ms per forward of the decoder's attention core in
the traced sub-window: the port's `mla_attention_bf16` kernel (matched whole
by its function name, `harness/trace.py:kernel_base`), over the forwards
the sub-window dispatched. Read only where it launched once per decoder
layer per forward; otherwise not read, and a note says how often it did
(a program without the kernel, as before it was written, launches it 0
times)."""

from benchmark.harness.trace import kernel_time

KERNEL = "mla_attention_bf16"


def read(rec):
    forwards = rec.trace_counts.get("forwards")
    if not rec.trace or not forwards:
        return None
    seconds, launches = kernel_time(rec.trace, (KERNEL,))
    want = rec.cell.model["decoder_layers"] * forwards
    if launches != want:
        rec.notes.append(f"attn.device_ms not read: {KERNEL} ({launches} launches, {want} "
                         f"expected)")
        return None
    return seconds * 1e3 / forwards
