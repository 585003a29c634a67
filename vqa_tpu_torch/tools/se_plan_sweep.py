"""Time the SE kernel under other launch plans than ``se_plan`` picks.

    python -m vqa_tpu_torch.tools.se_plan_sweep            # the f32 form
    python -m vqa_tpu_torch.tools.se_plan_sweep --bf16     # the bf16 form

For each full-width SE stage (224 px) at batch 32 and batch 1 (and, in
bf16, batch 8), and for each cluster size (f32: 4 to 16 blocks; bf16: 1
to 16, one block per image included) split by rows or by channels, it
launches ``csrc/se.cu`` with the rows held in shared memory (resident),
streamed (kept rows 0), and (f32) partly kept so that 2, 3 or 4 blocks fit
an SM; it checks each against ``plain_se`` (f32: 1e-3; bf16: one bf16 ulp)
and prints device ms (``vqa_tpu_torch.testing.time_ms``) and the clusters
the card holds at once. The plan ``se_plan`` picks is marked. Needs a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vqa_tpu_torch.ops._build import load_library
from vqa_tpu_torch.ops.se_kernel import (
    MAX_SMEM, SM_SHARED, SEPlan, _smem_bytes, max_active_clusters, plain_se, se_plan,
    slice_width)
from vqa_tpu_torch.testing import SE_STAGES, bf16_compare, card_line, time_ms
from vqa_tpu_torch.tools.roofline import HBM_GBPS


def plans(hw: int, c: int, r: int, esize: int = 4):
    per16 = 16 // esize
    clusters = (1, 2, 4, 8, 16) if esize == 2 else (4, 8, 12, 16)
    for rows in (True, False):
        for cluster in clusters:
            if cluster > (hw if rows else (c // per16 if c % per16 == 0 else c)):
                continue
            if esize == 2 and cluster == 1 and rows:
                continue  # one block per image: the two splits are the same
            full = -(-hw // cluster) if rows else hw
            width = c if rows else slice_width(c, cluster, esize)
            base = _smem_bytes(c, r, cluster, 0, rows, esize)
            keeps = {0}
            if _smem_bytes(c, r, cluster, full, rows, esize) <= MAX_SMEM:
                keeps.add(full)
            for per_sm in (2, 3, 4) if esize == 4 else ():
                keep = min(full, (SM_SHARED // per_sm - 1024 - base) // (esize * width))
                if keep > 0:
                    keeps.add(keep)
            for keep in sorted(keeps):
                yield SEPlan(cluster, rows, keep, _smem_bytes(c, r, cluster, keep, rows, esize))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="sweep the bf16 form's plans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("se_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    lib = load_library()
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    dtype, esize = (torch.bfloat16, 2) if args.bf16 else (torch.float32, 4)
    launcher = lib.vqa_se_bf16 if args.bf16 else lib.vqa_se_f32
    for b in ((32, 8, 1) if args.bf16 else (32, 1)):
        for side, c in SE_STAGES:
            hw, r = side * side, c // 16

            def randn(*shape, scale=1.0):
                return torch.from_numpy(
                    (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev).to(dtype)

            x = torch.relu(randn(b, side, side, c))
            w1, w2 = randn(r, c, scale=0.2), randn(c, r, scale=0.2)
            want = plain_se(x, w1, w2)
            out = torch.empty_like(x)
            chosen = se_plan(b, hw, c, r, esize)
            nbytes = esize * (2 * x.numel() + w1.numel() + w2.numel())
            print(f"B={b} {side}x{side}x{c} r={r} bytes bound "
                  f"{nbytes / (HBM_GBPS * 1e9) * 1e3:.4f} ms", flush=True)
            for plan in plans(hw, c, r, esize):
                def run(plan=plan):
                    rc = launcher(
                        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), b, hw, c,
                        r, plan.cluster, plan.keep_rows, int(plan.rows), plan.smem_bytes,
                        stream)
                    if rc:
                        raise RuntimeError(f"plan {plan} refused: CUDA error {rc}")
                out.zero_()
                run()
                torch.cuda.synchronize()
                if args.bf16:
                    ok = bf16_compare(torch, out, want)["ok"]
                else:
                    ok = float((out - want).abs().max()) <= 1e-3
                if not ok:
                    raise SystemExit(f"se_plan_sweep: FAILED: {plan} disagrees with plain_se")
                ms, _ = time_ms(torch, run, 50)
                active = max_active_clusters(plan, hw, c, r, 16 // esize, esize)
                print(f"  {'rows' if plan.rows else 'chan'} cluster {plan.cluster:2d} kept "
                      f"{plan.keep_rows:4d}/{plan.block_rows(hw):<4d} smem "
                      f"{plan.smem_bytes:6d} active {active:4d} ms {ms:.4f}"
                      f"{'  <- se_plan' if plan == chosen else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
