"""Run one cell of the benchmark of `vqa_tpu_torch` once, on this machine's cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell that `BENCHMARK.json` names (its configuration, its traffic
mix and the generator the mix names), sets up, warms up, measures for
`--seconds`, compares what the timed path produced with the plain
reference, and prints one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks` (each number compared, with its limit,
also printed as the last lines of standard error).

It exits non-zero and prints no result where no CUDA card is present or
fewer than the cell asks for, and where `jax`, `jaxlib`, `flax` or the JAX
package `vqa_tpu` has been imported once the window has closed.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# build and kernel caches stay in the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "vqa_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no reading"


def result_line(rec, trace: bool, readers) -> dict:
    import torch

    metrics = {}
    for m in (rec.cell.per_layer if trace else rec.cell.end_to_end):
        value = readers[m["name"]](rec)
        if value is None or not math.isfinite(value):
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": rec.cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace:
        from benchmark.harness.trace import breakdown

        if rec.trace is None:
            raise RuntimeError(f"the traced sub-window read nothing: {rec.trace_reason}")
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = breakdown(rec.trace, rec.trace_idle)
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in rec.checks.items()}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda"):
    """Set up, warm up, measure and compare one run of `cell`: (record,
    result line). Needs the cards `main` has looked for."""
    from benchmark.harness import spec

    readers = spec.readers(cell.per_layer if trace else cell.end_to_end)
    rec = spec.kind(cell.traffic["kind"]).run(cell, seed, seconds, trace, T0, device=device)
    return rec, result_line(rec, trace, readers)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness import spec

    cell = spec.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s), this machine "
              f"has {n}; nothing is measured on the CPU", file=sys.stderr)
        return 2
    from benchmark.costs import peaks

    print(f"card: {card_line()}; peaks against which shares are stated: "
          f"{peaks.BF16_FLOP_PER_S / 1e12:g} TFLOP/s bf16, "
          f"{peaks.HBM_BYTES_PER_S / 1e12:g} TB/s", flush=True)
    rec, line = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run imported {', '.join(found)}; the port may not load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for note in rec.notes:
        print(note)
    for name, c in rec.checks.items():
        print(f"check {name}: {c.value!r} (limit {c.limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
