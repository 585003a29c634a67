"""Where the bf16 SE and cross-attention kernels' time goes, on the card.

    python -m vqa_tpu_torch.tools.bf16_phases            # from the repository root

Builds copies of ``csrc/se.cu`` and ``csrc/cross_attention.cu`` in which
thread 0 of every block (up to 1,024) stamps ``clock64()`` and
``%globaltimer`` at each ``// phase N:`` line of the bf16 kernels
(``se_bf16``, ``cross_attention_bf16``), and launches them at the main
path's bucket-32 shapes with seeded inputs: SE at the four stages under
``se_plan``'s plan and under other cluster sizes, cross-attention once.
Each launch is checked against its plain version (one bf16 ulp) and timed
as device ms per launch: a CUDA graph of 20 launches, replayed and timed
with CUDA events (no profiler). From the stamps of one launch it prints
the spread of the blocks' start times (how long the card takes to put
every block on an SM), the median block's time from its first to its last
stamp, and the median SM cycles of each phase: for SE, issuing the copies,
each thread's sums (the wait for its rows), the block's sums, the pooled
means (and the staged weights), fc1 with the cluster's exchange, fc2, the
rescale; for cross-attention, staging q, k and v, then for thread 0's
rows the scores, the softmax, the context and their stores. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys
import tempfile

MAX_BLOCKS, MAX_PHASES = 1024, 8
KERNELS = {"se.cu": "se_bf16", "cross_attention.cu": "cross_attention_bf16"}


def instrumented_source(src: str, tag: str) -> str:
    """A kernel source with a stamp after each ``// phase N:`` line and a
    reader ``vqa_<tag>_stamps``."""
    head = (f"__device__ long long vqa_{tag}_clk[{MAX_BLOCKS}][{MAX_PHASES}];\n"
            f"__device__ unsigned long long vqa_{tag}_ns[{MAX_BLOCKS}][{MAX_PHASES}];\n"
            f"#define VQA_STAMP(k) do {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{ "
            f"unsigned long long g_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); "
            f"vqa_{tag}_clk[blockIdx.x][k] = clock64(); vqa_{tag}_ns[blockIdx.x][k] = g_; }} "
            f"}} while (0)\n")
    src, n = re.subn(r"^(\s*)// phase (\d+):.*$", r"\g<0>\n\1VQA_STAMP(\2);", src, flags=re.M)
    if n < 2:
        raise SystemExit(f"bf16_phases: no phase lines in the {tag} source")
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + head, 1)
    return src + (f"\nVQA_EXPORT int vqa_{tag}_stamps(long long* clk, unsigned long long* ns) {{\n"
                  f"  cudaError_t e = cudaMemcpyFromSymbol(clk, vqa_{tag}_clk, "
                  f"sizeof(vqa_{tag}_clk));\n"
                  f"  if (e != cudaSuccess) return e;\n"
                  f"  return cudaMemcpyFromSymbol(ns, vqa_{tag}_ns, sizeof(vqa_{tag}_ns));\n}}\n")


def build(tmp: str) -> ctypes.CDLL:
    from vqa_tpu_torch.ops import _build

    for name in ("common.cuh", "common.cu", *KERNELS):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        if name in KERNELS:
            src = instrumented_source(src, name.split(".")[0])
        with open(os.path.join(tmp, name), "w") as f:
            f.write(src)
    procs = [subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-c",
                               os.path.join(tmp, name), "-o", os.path.join(tmp, name + ".o")])
             for name in ("common.cu", *KERNELS)]
    if any(p.wait() for p in procs):
        raise SystemExit("bf16_phases: nvcc failed")
    lib = os.path.join(tmp, "libbf16_phases.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                    *(os.path.join(tmp, n + ".o") for n in ("common.cu", *KERNELS))],
                   check=True)
    out = ctypes.CDLL(lib)
    for name in ("vqa_se_bf16", "vqa_cross_attention_bf16"):
        getattr(out, name).argtypes = _build._SIGNATURES[name]
    for tag in ("se", "cross_attention"):
        getattr(out, f"vqa_{tag}_stamps").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return out


def graph_ms(torch, launch, n: int = 20, replays: int = 10) -> float:
    """Device ms per launch: ``n`` launches captured in one CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def stamps(lib, tag: str, blocks: int, phases: int) -> dict:
    """The stamps of the last launch: start spread, median block time, and
    the median cycles of each phase over the blocks."""
    import numpy as np

    clk = np.zeros((MAX_BLOCKS, MAX_PHASES), np.int64)
    ns = np.zeros((MAX_BLOCKS, MAX_PHASES), np.uint64)
    rc = getattr(lib, f"vqa_{tag}_stamps")(clk.ctypes.data, ns.ctypes.data)
    if rc:
        raise SystemExit(f"bf16_phases: reading the {tag} stamps failed: {rc}")
    n = min(blocks, MAX_BLOCKS)
    clk, ns = clk[:n, :phases], ns[:n, :phases].astype(np.int64)
    cycles = np.diff(clk, axis=1)
    return dict(start_spread_us=float(ns[:, 0].max() - ns[:, 0].min()) / 1e3,
                block_us=float(np.median(ns[:, -1] - ns[:, 0])) / 1e3,
                span_us=float(ns[:, -1].max() - ns[:, 0].min()) / 1e3,
                phase_cycles=[float(np.median(cycles[:, k])) for k in range(phases - 1)])


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bf16_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.ops.se_kernel import SEPlan, _smem_bytes, se_plan
    from vqa_tpu_torch.testing import BUCKET, SE_STAGES, bf16_compare, card_line
    from vqa_tpu_torch.utils.config import ModelConfig

    print(card_line(), flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)
    b = BUCKET

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev).to(bf16)

    with tempfile.TemporaryDirectory(prefix="bf16_phases.") as tmp:
        lib = build(tmp)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for side, c in SE_STAGES:
            hw, r = side * side, c // 16
            x = torch.relu(randn(b, side, side, c))
            w1, w2 = randn(r, c, scale=0.2), randn(c, r, scale=0.2)
            want = ops.plain_se(x, w1, w2)
            chosen = se_plan(b, hw, c, r, 2)
            candidates = {chosen}
            for n in (1, 2, 4, 8):
                rows = c // n < 16
                if (hw if rows else c // 8) >= n:
                    candidates.add(SEPlan(n, rows, -(-hw // n) if rows else hw,
                                          _smem_bytes(c, r, n, -(-hw // n) if rows else hw,
                                                      rows, 2)))
            for plan in sorted(candidates, key=lambda q: q.cluster):
                if plan.smem_bytes > 232_448:
                    continue
                out = torch.empty_like(x)

                def launch(plan=plan, out=out):
                    rc = lib.vqa_se_bf16(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                         out.data_ptr(), b, hw, c, r, plan.cluster,
                                         plan.keep_rows, int(plan.rows), plan.smem_bytes,
                                         stream())
                    if rc:
                        raise SystemExit(f"bf16_phases: SE plan {plan} refused: {rc}")
                launch()
                torch.cuda.synchronize()
                if not bf16_compare(torch, out, want)["ok"]:
                    raise SystemExit(f"bf16_phases: SE {plan} disagrees with plain_se")
                ms = graph_ms(torch, launch)
                launch()
                torch.cuda.synchronize()
                st = stamps(lib, "se", b * plan.cluster, 8)
                print(f"se stage {side}x{side}x{c} cluster {plan.cluster} "
                      f"{'rows' if plan.rows else 'chan'}"
                      f"{' (se_plan)' if plan == chosen else ''}: {ms:.4f} ms per launch; "
                      f"block starts spread {st['start_spread_us']:.2f} us, median block "
                      f"{st['block_us']:.2f} us, first start to last stamp "
                      f"{st['span_us']:.2f} us; phase cycles "
                      f"{[round(v) for v in st['phase_cycles']]}", flush=True)
        cfg = ModelConfig()
        heads, dh = cfg.num_attention_heads, cfg.embed_dim // cfg.num_attention_heads
        lq, lkv = cfg.max_question_length, cfg.feature_spatial_size ** 2
        q, k, v = (randn(b, n, heads, dh).transpose(1, 2) for n in (lq, lkv, lkv))
        pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(dh))
        ctx = torch.empty((b, lq, heads, dh), dtype=bf16, device=dev).transpose(1, 2)
        w = torch.empty((b, heads, lq, lkv), dtype=bf16, device=dev)
        strides = [s for t in (q, k, v, ctx) for s in t.stride()[:3]]

        def launch_ca():
            rc = lib.vqa_cross_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(), w.data_ptr(), b,
                heads, lq, lkv, dh, *strides, 1.0 / math.sqrt(dh), stream())
            if rc:
                raise SystemExit(f"bf16_phases: cross-attention refused: {rc}")
        launch_ca()
        torch.cuda.synchronize()
        if not (bf16_compare(torch, ctx, pctx)["ok"] and bf16_compare(torch, w, pw)["ok"]):
            raise SystemExit("bf16_phases: cross-attention disagrees with its plain version")
        ms = graph_ms(torch, launch_ca)
        launch_ca()
        torch.cuda.synchronize()
        st = stamps(lib, "cross_attention", b * heads, 6)
        print(f"cross_attention q{tuple(q.shape)} kv{tuple(k.shape)}: {ms:.4f} ms per launch; "
              f"block starts spread {st['start_spread_us']:.2f} us, median block "
              f"{st['block_us']:.2f} us, first start to last stamp {st['span_us']:.2f} us; "
              f"phase cycles {[round(v) for v in st['phase_cycles']]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
