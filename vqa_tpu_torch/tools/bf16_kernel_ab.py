"""Time the bf16 SE and cross-attention kernels of two checkouts in turns.

    python -m vqa_tpu_torch.tools.bf16_kernel_ab --other DIR [--rounds 2] [--forward]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists). Each measurement is a process of its own that imports the
``vqa_tpu_torch`` of one checkout, builds its kernels and times, on the
card, at the main path's bucket-32 shapes with seeded inputs: the bf16 SE
kernel at each of the four stages and the bf16 cross-attention kernel
(two calls per forward), device ms from a profiler trace (this checkout's
``vqa_tpu_torch/testing.py:time_ms``, for both sides) and per call of a
CUDA graph of 20 calls timed with CUDA events; with ``--forward`` also the
graphed bf16 engine's device ms per bucket-32 ``predict_probs_from_pixels``
call (full width, seeded weights). The processes run other, this, this, other in
each round, so both sides share the card's state. Prints one JSON line
per process and a summary (median and range per side). Needs a CUDA
device; runs only on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(torch, fn, n: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph
    (as the engine's graphs hold them), replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def this_checkouts_testing():
    """This checkout's ``vqa_tpu_torch/testing.py``, loaded by path: the
    measuring process imports the other checkout's package, which may have
    no such module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bf16_kernel_ab_testing", os.path.join(REPO, "vqa_tpu_torch", "testing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(forward: bool) -> dict:
    """One side's numbers, in this process (its ``sys.path`` picks the
    checkout's kernels; the timing is this checkout's)."""
    import numpy as np
    import torch

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.utils.config import ModelConfig

    testing = this_checkouts_testing()
    ops._build.load_library()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)
    cfg = ModelConfig()
    b = testing.BUCKET

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev).to(bf16)

    out = {"repo": os.getcwd(), "se_stage_ms": [], "se_stage_graph_ms": []}
    with torch.no_grad():
        for side, c in testing.SE_STAGES:
            r = c // 16
            x = torch.relu(randn(b, side, side, c))
            w1, w2 = randn(r, c, scale=0.2), randn(c, r, scale=0.2)
            ms, _ = testing.time_ms(torch, lambda: ops.fused_se(x, w1, w2), 50)
            out["se_stage_ms"].append(ms)
            out["se_stage_graph_ms"].append(graph_ms(torch, lambda: ops.fused_se(x, w1, w2)))
        out["se_ms"] = sum(out["se_stage_ms"])
        out["se_graph_ms"] = sum(out["se_stage_graph_ms"])
        heads, dh = cfg.num_attention_heads, cfg.embed_dim // cfg.num_attention_heads
        lq, lkv = cfg.max_question_length, cfg.feature_spatial_size ** 2
        q, k, v = (randn(b, n, heads, dh).transpose(1, 2) for n in (lq, lkv, lkv))
        ms, _ = testing.time_ms(
            torch, lambda: ops.fused_cross_attention(q, k, v, math.sqrt(dh)), 200)
        out["cross_attention_ms"] = cfg.num_cross_layers * ms
        out["cross_attention_graph_ms"] = cfg.num_cross_layers * graph_ms(
            torch, lambda: ops.fused_cross_attention(q, k, v, math.sqrt(dh)))
    if forward:
        from torch.profiler import ProfilerActivity, profile

        from vqa_tpu_torch.serving.engine import VQAInference

        engine = VQAInference(model_config=cfg, device="cuda", seed=0).load()
        size = cfg.image_size
        pixels = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
        questions = [testing.HTTP_QUESTIONS[i % 5] for i in range(b)]
        for _ in range(5):
            engine.predict_probs_from_pixels(pixels, questions)
        torch.cuda.synchronize()
        calls = 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                engine.predict_probs_from_pixels(pixels, questions)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in testing.device_events(prof))
        out["graphed_forward_device_ms"] = busy / 1e3 / calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="the other checkout's root")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--forward", action="store_true",
                   help="also time the graphed bf16 forward at bucket 32")
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.measure:
        import torch

        if not torch.cuda.is_available():
            print("bf16_kernel_ab: needs a CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(measure(args.forward)), flush=True)
        return 0
    if not args.other:
        p.error("--other DIR is required")
    other = os.path.abspath(args.other)
    runs = {REPO: [], other: []}
    for _ in range(args.rounds):
        for repo in (other, REPO, REPO, other):
            env = dict(os.environ, PYTHONPATH=repo)
            cmd = [sys.executable, os.path.join(REPO, "vqa_tpu_torch", "tools",
                                                "bf16_kernel_ab.py"), "--measure"]
            if args.forward:
                cmd.append("--forward")
            # the measuring process imports the checkout's own package
            proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                                  timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"bf16_kernel_ab: FAILED: a measurement in {repo} "
                                 f"exited {proc.returncode}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[repo].append(line)
    summary = {}
    for name, repo in (("this", REPO), ("other", other)):
        keys = [k for k in runs[repo][0]
                if k not in ("repo", "se_stage_ms", "se_stage_graph_ms")]
        side = {k: [r[k] for r in runs[repo]] for k in keys}
        for i in range(len(runs[repo][0]["se_stage_ms"])):
            side[f"se_stage{i + 1}_ms"] = [r["se_stage_ms"][i] for r in runs[repo]]
            side[f"se_stage{i + 1}_graph_ms"] = [r["se_stage_graph_ms"][i] for r in runs[repo]]
        summary[name] = {k: dict(median=statistics.median(v), min=min(v), max=max(v))
                         for k, v in side.items()}
    print(json.dumps({"bf16_kernel_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
