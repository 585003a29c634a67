"""Readings of a cell's control: the plain reference in fp8 put in the
program's place, on several seeds, at the cell's own sizes.

    python benchmark/control.py --config vqa_ref --traffic infer_b32 --seeds 11 12 13

Prints one JSON line per seed with each number the cell compares, as the
control reads it (`control_readings` of the cell's traffic kind). The
limits in the traffic files lie between the program's readings and these.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="a file's name under benchmark/configs")
    p.add_argument("--traffic", required=True, help="a file's name under benchmark/traffic")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.compose(args.config, args.traffic)
    kind = spec.kind(cell.traffic["kind"])
    for seed in args.seeds:
        readings = kind.control_readings(cell, seed, args.device)
        print(json.dumps({"cell": cell.name, "seed": seed, "control": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
