"""Time the SE kernel under other launch plans than ``se_plan`` picks.

    python -m vqa_tpu_torch.tools.se_plan_sweep   # from the repository root

For each full-width SE stage (224 px) at batch 32 and batch 1, and for
clusters of 4 to 16 blocks split by rows or by channels, it launches
``csrc/se.cu`` with the rows held in shared memory (resident), streamed
(kept rows 0), and partly kept so that 2, 3 or 4 blocks fit an SM; it
checks each against ``plain_se`` (1e-3) and prints device ms
(``chip_smoke.time_ms``) and the clusters the card holds at once. The plan
``se_plan`` picks is marked. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from vqa_tpu_torch.ops._build import load_library  # noqa: E402
from vqa_tpu_torch.ops.se_kernel import (  # noqa: E402
    MAX_SMEM, SM_SHARED, SEPlan, _smem_bytes, max_active_clusters, plain_se, se_plan,
    slice_width)


def plans(hw: int, c: int, r: int):
    for rows in (True, False):
        for cluster in (4, 8, 12, 16):
            if cluster > (hw if rows else (c // 4 if c % 4 == 0 else c)):
                continue
            full = -(-hw // cluster) if rows else hw
            width = c if rows else slice_width(c, cluster)
            base = _smem_bytes(c, r, cluster, 0, rows)
            keeps = {0}
            if _smem_bytes(c, r, cluster, full, rows) <= MAX_SMEM:
                keeps.add(full)
            for per_sm in (2, 3, 4):
                keep = min(full, (SM_SHARED // per_sm - 1024 - base) // (4 * width))
                if keep > 0:
                    keeps.add(keep)
            for keep in sorted(keeps):
                yield SEPlan(cluster, rows, keep, _smem_bytes(c, r, cluster, keep, rows))


def main() -> int:
    if not torch.cuda.is_available():
        print("se_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    lib = load_library()
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b in (32, 1):
        for side, c in chip_smoke.SE_STAGES:
            hw, r = side * side, c // 16
            x = torch.relu(torch.from_numpy(
                rng.standard_normal((b, side, side, c)).astype(np.float32)).to(dev))
            w1 = torch.from_numpy((rng.standard_normal((r, c)) * 0.2).astype(np.float32)).to(dev)
            w2 = torch.from_numpy((rng.standard_normal((c, r)) * 0.2).astype(np.float32)).to(dev)
            want = plain_se(x, w1, w2)
            out = torch.empty_like(x)
            chosen = se_plan(b, hw, c, r)
            print(f"B={b} {side}x{side}x{c} r={r}", flush=True)
            for plan in plans(hw, c, r):
                def run(plan=plan):
                    rc = lib.vqa_se_f32(
                        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), b, hw, c,
                        r, plan.cluster, plan.keep_rows, int(plan.rows), plan.smem_bytes,
                        stream)
                    if rc:
                        raise RuntimeError(f"plan {plan} refused: CUDA error {rc}")
                out.zero_()
                run()
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if err > 1e-3:
                    raise SystemExit(f"se_plan_sweep: FAILED: {plan} max abs err {err}")
                ms, _ = chip_smoke.time_ms(torch, run, 50)
                print(f"  {'rows' if plan.rows else 'chan'} cluster {plan.cluster:2d} kept "
                      f"{plan.keep_rows:4d}/{plan.block_rows(hw):<4d} smem "
                      f"{plan.smem_bytes:6d} active "
                      f"{max_active_clusters(plan, hw, c, r):4d} ms {ms:.4f}"
                      f"{'  <- se_plan' if plan == chosen else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
