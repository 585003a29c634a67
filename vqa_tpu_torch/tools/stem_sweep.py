"""Time the bf16 stem kernel under every layout it takes, at buckets 1, 8, 32.

    python -m vqa_tpu_torch.tools.stem_sweep               # from the repository root
    python -m vqa_tpu_torch.tools.stem_sweep --repo DIR    # another checkout's stem

For batch 1, 8 and 32 at 224 px (cout 64, the engine's stem), it launches
``csrc/stem.cu``'s bf16 form with its patch by TMA (the plan ``stem_plan``
picks at these shapes) and by plain loads (the route it takes where TMA
cannot take x). Each is checked against ``plain_stem``
(one bf16 ulp + ``vqa_tpu_torch.testing.STEM_BF16_ATOL``), run for half a
second so that the card has left its idle clock, and timed with
``vqa_tpu_torch.testing.time_ms``; the SM clock and power nvidia-smi reads
after that warm-up are printed beside each time. Its weights are N(0,
2/147), not the model's initialisation: on the H100 these inputs time
~1.4x slower than ``chip_smoke.py``'s at the same clock, for the parent's
kernel and this one alike, so compare times within one tool.

With ``--repo DIR`` it imports ``vqa_tpu_torch`` from DIR instead and times
that checkout's public ``ops.fused_stem`` on the same inputs (no plans),
with this checkout's timing and comparison: the way to hold two versions
of the kernel against each other on one card, run in turns (parent,
change, change, parent) on one card. The last
line is one JSON object of the times. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from vqa_tpu_torch.testing import STEM_BF16_ATOL, bf16_compare, card_line, time_ms

BUCKETS = (1, 8, 32)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def inputs(torch, b: int, seed: int = 0):
    """Normalized 224 px pixels and the engine's stem shapes, made with numpy
    so that any checkout sees the same values: x [b,224,224,3] and w
    [64,3,7,7] bf16, scale and bias [64] f32."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (b, 224, 224, 3)).astype(np.float32) / 255.0 - MEAN) / STD
    w = rng.standard_normal((64, 3, 7, 7)).astype(np.float32) * np.float32(np.sqrt(2 / 147))
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(x).to(dev).bfloat16(), torch.from_numpy(w).to(dev).bfloat16(),
            torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev))


def sm_clock() -> str:
    """The SM clock and power draw nvidia-smi reads now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=None,
                   help="time the public fused_stem of the checkout in this directory")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stem_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    if args.repo:
        sys.path.insert(0, os.path.abspath(args.repo))
        for name in [m for m in sys.modules if m.split(".")[0] == "vqa_tpu_torch"]:
            del sys.modules[name]
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.ops import _build

    print(card_line(), flush=True)
    print(f"stem_sweep: vqa_tpu_torch from {os.path.dirname(os.path.dirname(ops.__file__))}",
          flush=True)
    _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for b in BUCKETS:
        x, w, scale, bias = inputs(torch, b)
        want = ops.plain_stem(x, w, scale, bias)

        def checked(name, fn):
            out = fn()
            torch.cuda.synchronize()
            c = bf16_compare(torch, out, want, STEM_BF16_ATOL)
            if not c["ok"]:
                raise SystemExit(f"stem_sweep: FAILED: {name} at B={b}: {c}")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.5:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            clock = sm_clock()
            ms, call_ms = time_ms(torch, fn, args.iters)
            return dict(ms=ms, call_ms=call_ms, ulps=c["ulps"], beyond=c["beyond"], clock=clock)

        if args.repo:
            r = checked("fused_stem", lambda: ops.fused_stem(x, w, scale, bias))
            print(f"B={b:2d} fused_stem ms {r['ms']:.4f} (per call {r['call_ms']:.4f}; "
                  f"SM clock, power {r['clock']})", flush=True)
            result[str(b)] = r
            continue
        from vqa_tpu_torch.ops.stem_kernel import stem_output_hw, stem_plan

        lib = _build.load_library()
        plan = stem_plan(b, 224, 224, 64)
        out = torch.empty((b, *stem_output_hw(224, 224), 64), dtype=torch.bfloat16,
                          device=x.device)
        result[str(b)] = {}
        for tma in (True, False):
            def run(tma=tma):
                rc = lib.vqa_stem_bf16(
                    x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), b, 224, 224, 64, int(tma), plan.smem_bytes, stream)
                if rc:
                    raise RuntimeError(f"{plan} with tma={tma} refused: CUDA error {rc}")
                return out

            name = "tma" if tma else "plain loads"
            r = checked(name, run)
            print(f"B={b:2d} patch by {name:11s} grid {plan.grid:3d} smem {plan.smem_bytes:6d} "
                  f"ms {r['ms']:.4f} (per call {r['call_ms']:.4f}), {r['ulps']:.3f} ulp; SM "
                  f"clock, power {r['clock']}", flush=True)
            result[str(b)][name] = r
    print(json.dumps({"stem_sweep": result, "repo": args.repo or "."}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
