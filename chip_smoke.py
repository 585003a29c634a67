#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

What it does, failing (non-zero exit, no result line) on any failed check:

1. prints the card (name and power limit from nvidia-smi) and builds the
   CUDA kernels from ``vqa_tpu_torch/csrc`` with nvcc, timing the build;
2. builds the serving engine at full width (19,310,316 parameters, seeded
   random weights) and, at the main path's shapes for batch bucket 32,
   holds each kernel against its plain PyTorch version on the card and
   times kernel, plain version and — where one PyTorch call computes the
   same function — that call as a yardstick the port never uses;
3. zeroes the kernels' launch counters, drives the main path through the
   engine's entry points (warmup of every bucket, ``predict`` on PNG
   bytes, ``predict_batch`` / ``predict_batch_raw`` of 5 and 40 requests,
   ``attention_map``), checks shapes, finiteness and that probability rows
   sum to 1, and checks that every forward launched the stem, SE and
   cross-attention kernels 1, 4 and 2 times;
4. compares whole-model logits through the kernels with the same model
   through the plain versions, on the card (max abs error <= 1e-3);
5. measures pairs/s through ``predict_probs_from_pixels`` at buckets 1
   and 32.

All times are per forward at bucket 32 (the stem runs once, SE four
times at the four stage shapes, cross-attention twice). ``ms`` is device
time from a torch.profiler trace of repeated calls (inputs resident in L2
where they fit); the per-call time from CUDA events, which includes the
host's launch overhead where that is the slower side, is logged beside it.
The bound of each kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its f32 operations over
67 TFLOP/s, the published H100 SXM peaks.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one JSON line of per-kernel
numbers.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
BUCKET = 32
SE_STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))  # (H = W, C) at 224 px


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def time_ms(torch, fn, iters: int):
    """(device ms, call ms) per call of ``fn``.

    Device ms: the card's busy time per call — the sum of the kernels' (and
    copies') durations from a torch.profiler trace over ``iters`` calls.
    Call ms: CUDA events around ``iters`` back-to-back calls, which also
    counts the host's launch overhead wherever the host is the slower side.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in device_events(prof))
    require(busy_us > 0, "the profiler saw no device time")
    return busy_us / 1e3 / iters, call_ms


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def check_kernels(torch, engine, rng):
    """Kernel against plain version on the card, plus timings and bounds."""
    import torch.nn.functional as F

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_normalize

    dev = engine.device
    model = engine.model
    results = {}

    # ---- stem --------------------------------------------------------
    size = model.config.image_size
    pixels = torch.from_numpy(
        rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)).to(dev)
    x = device_normalize(pixels).contiguous()
    w = model.image_encoder.stem[0].weight
    cout = w.shape[0]
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(dev)
    got, want = ops.fused_stem(x, w, scale, bias), ops.plain_stem(x, w, scale, bias)
    torch.cuda.synchronize()
    require(got.shape == want.shape, f"stem shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = max_err(got, want)
    log(f"stem {tuple(x.shape)} -> {tuple(got.shape)}: max abs err {err:.3e} (tol 1e-5)")
    require(torch.allclose(got, want, atol=1e-5, rtol=1e-5), "stem disagrees with plain_stem")
    ch = (size - 1) // 2 + 1
    flops = (2 * BUCKET * ch * ch * cout * 147 + 3 * BUCKET * ch * ch * cout
             + 8 * got.numel())
    nbytes = 4 * (x.numel() + w.numel() + 2 * cout + got.numel())
    bnd, by = bound_ms(nbytes, flops)
    (k_ms, k_call), (p_ms, p_call) = (
        time_ms(torch, lambda: ops.fused_stem(x, w, scale, bias), 20),
        time_ms(torch, lambda: ops.plain_stem(x, w, scale, bias), 20))
    results["stem"] = dict(
        route="cuda", source="vqa_tpu_torch/csrc/stem.cu",
        replaces="vqa_tpu/ops/stem_kernel.py:141", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, call_ms=k_call, plain_call_ms=p_call,
        bound_ms=bnd, bound_by=by, library_ms=None)

    # ---- SE, at the four stage shapes ---------------------------------
    se = dict(route="cuda", source="vqa_tpu_torch/csrc/se.cu",
              replaces="vqa_tpu/ops/se_kernel.py:50", max_abs_err=0.0, ms=0.0,
              plain_ms=0.0, call_ms=0.0, plain_call_ms=0.0, library_ms=None)
    se_bytes = se_flops = 0
    for i, (hw, c) in enumerate(SE_STAGES, start=1):
        mod = getattr(model.image_encoder, f"stage{i}").attention.se
        w1, w2 = mod.fc1.weight, mod.fc2.weight
        xs = torch.relu(torch.from_numpy(
            rng.standard_normal((BUCKET, hw, hw, c)).astype(np.float32)).to(dev))
        got, want = ops.fused_se(xs, w1, w2), ops.plain_se(xs, w1, w2)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"se stage{i} {tuple(xs.shape)} r={w1.shape[0]}: max abs err {err:.3e} (tol 1e-3)")
        require(torch.allclose(got, want, atol=1e-3, rtol=1e-3), f"se stage{i} disagrees")
        se["max_abs_err"] = max(se["max_abs_err"], err)
        k_ms, k_call = time_ms(torch, lambda: ops.fused_se(xs, w1, w2), 50)
        p_ms, p_call = time_ms(torch, lambda: ops.plain_se(xs, w1, w2), 50)
        log(f"se stage{i}: kernel {k_ms:.4f} ms on the device ({k_call:.4f} ms per "
            f"call), plain {p_ms:.4f} ms ({p_call:.4f} ms per call)")
        se["ms"] += k_ms
        se["plain_ms"] += p_ms
        se["call_ms"] += k_call
        se["plain_call_ms"] += p_call
        se_bytes += 4 * (2 * xs.numel() + w1.numel() + w2.numel())
        se_flops += 2 * xs.numel() + 4 * BUCKET * c * w1.shape[0] + 4 * BUCKET * c
    se["bound_ms"], se["bound_by"] = bound_ms(se_bytes, se_flops)
    results["se"] = se

    # ---- cross-attention, both fusion layers -------------------------
    cfg = model.config
    heads, dh = cfg.num_attention_heads, cfg.embed_dim // cfg.num_attention_heads
    lq, lkv = cfg.max_question_length, cfg.feature_spatial_size ** 2
    nlayers = cfg.num_cross_layers

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    q, k, v = randn(BUCKET, heads, lq, dh), randn(BUCKET, heads, lkv, dh), randn(
        BUCKET, heads, lkv, dh)
    sc = math.sqrt(dh)
    (ctx, wts), (pctx, pw) = (ops.fused_cross_attention(q, k, v, sc),
                              ops.plain_cross_attention(q, k, v, sc))
    torch.cuda.synchronize()
    err_ctx, err_w = max_err(ctx, pctx), max_err(wts, pw)
    log(f"cross_attention q{tuple(q.shape)} kv{tuple(k.shape)}: max abs err ctx "
        f"{err_ctx:.3e} (tol 1e-5), w {err_w:.3e} (tol 1e-6)")
    require(torch.allclose(ctx, pctx, atol=1e-5, rtol=1e-5), "cross-attention ctx disagrees")
    require(torch.allclose(wts, pw, atol=1e-6, rtol=1e-5), "cross-attention w disagrees")
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + ctx.numel() + wts.numel())
    flops = 4 * BUCKET * heads * lq * lkv * dh + 5 * wts.numel()
    bnd, by = bound_ms(nlayers * nbytes, nlayers * flops)
    k_ms, k_call = time_ms(torch, lambda: ops.fused_cross_attention(q, k, v, sc), 200)
    p_ms, p_call = time_ms(torch, lambda: ops.plain_cross_attention(q, k, v, sc), 200)
    # yardstick only: the context alone, no probabilities
    lib_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 200)
    results["cross_attention"] = dict(
        route="cuda", source="vqa_tpu_torch/csrc/cross_attention.cu",
        replaces="vqa_tpu/ops/cross_attention_kernel.py:73",
        max_abs_err=max(err_ctx, err_w), ms=nlayers * k_ms, plain_ms=nlayers * p_ms,
        call_ms=nlayers * k_call, plain_call_ms=nlayers * p_call,
        bound_ms=bnd, bound_by=by, library_ms=nlayers * lib_ms)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name} per forward: kernel {r['ms']:.4f} ms on the device "
            f"({r['call_ms']:.4f} ms per call), plain {r['plain_ms']:.4f} ms "
            f"({r['plain_call_ms']:.4f} ms per call), library {lib} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def png_bytes(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def drive_main_path(engine, rng):
    """The serving calls a user makes; returns the number of forwards."""
    questions = ["what color is the cat", "how many dogs are there", "is this a man",
                 "what is the woman wearing", "what is on the table"]
    n_classes = engine.model.config.num_answers
    forwards = 0

    engine.warmup()
    forwards += len(engine.cfg.batch_buckets)

    img = png_bytes(rng, 240, 320)
    single = engine.predict(img, questions[0], top_k=5)
    forwards += 1
    require(len(single["answers"]) == 5 and math.isfinite(single["confidence"]),
            f"predict returned {single}")
    probs = [a["probability"] for a in single["answers"]]
    require(probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1 + 1e-5,
            "predict's top-5 are not sorted probabilities")

    for n in (5, 40):
        images = [png_bytes(rng, int(h), int(w)) for h, w in rng.integers(64, 400, (n, 2))]
        qs = [questions[i % len(questions)] for i in range(n)]
        chunks = -(-n // engine.cfg.batch_buckets[-1])
        results = engine.predict_batch(images, qs, top_k=3)
        raw = engine.predict_batch_raw(images, qs)
        forwards += 2 * chunks
        require(len(results) == n and all(len(r["answers"]) == 3 for r in results),
                f"predict_batch({n}) shape")
        require(raw.shape == (n, n_classes) and np.isfinite(raw).all(),
                f"predict_batch_raw({n}) gave {raw.shape}, finite={np.isfinite(raw).all()}")
        row_err = float(np.abs(raw.sum(-1) - 1).max())
        require(row_err < 1e-4, f"probability rows of {n} requests sum to 1 +- {row_err}")
        top = np.asarray([r["confidence"] for r in results])
        require(np.allclose(top, raw.max(-1), atol=1e-5),
                "predict_batch and predict_batch_raw disagree")
        log(f"predict_batch({n}): {chunks} forward(s), rows sum to 1 within {row_err:.1e}")
    # padding to a bucket must not change a request's answer
    alone = engine.predict(images[0], qs[0], top_k=1)["confidence"]
    forwards += 1
    require(abs(alone - float(raw[0].max())) < 1e-4,
            f"request alone {alone} vs in a padded batch {raw[0].max()}")

    att = engine.attention_map(img, questions[0])
    forwards += 1
    maps = np.asarray(att["attention"]["maps"])
    s = engine.model.config.feature_spatial_size
    require(maps.shape == (len(att["attention"]["tokens"]), s, s),
            f"attention maps {maps.shape}")
    require(np.isfinite(maps).all() and np.allclose(maps.sum((1, 2)), 1, atol=1e-4),
            "attention maps do not sum to 1 over the image grid")
    log(f"attention_map: tokens {att['attention']['tokens']}, maps {maps.shape}")
    return forwards


def compare_whole_model(torch, engine, rng) -> float:
    """Logits through the kernels against the same model through the plain
    versions, on the card, same weights and inputs."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel

    size = engine.model.config.image_size
    pixels = torch.from_numpy(
        rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)).to(engine.device)
    ids, mask = engine.tokenizer.encode_batch_np(["what is the man doing"] * BUCKET)
    ids = torch.from_numpy(ids).long().to(engine.device)
    mask = torch.from_numpy(mask).to(engine.device)
    with torch.inference_mode():
        kernel_logits, _ = engine.model(device_normalize(pixels), ids, mask)
        before = ops.launch_counts()
        with mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
                mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
                mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                                  cross_attention_kernel.plain_cross_attention):
            plain_logits, _ = engine.model(device_normalize(pixels), ids, mask)
        torch.cuda.synchronize()
    require(ops.launch_counts() == before, "the plain run launched a kernel")
    require(bool(torch.isfinite(kernel_logits).all()), "non-finite logits")
    err = max_err(kernel_logits, plain_logits)
    log(f"whole-model logits [{BUCKET}, {kernel_logits.shape[1]}], kernels vs plain on "
        f"the card: max abs err {err:.3e} (tol 1e-3)")
    require(err <= 1e-3, "whole-model logits disagree")
    return err


def throughput(engine, rng):
    """Pairs/s and per-call latency through predict_probs_from_pixels."""
    size = engine.model.config.image_size
    out = {}
    # 100 calls: the p90 has 10 samples beyond it
    for bucket, iters in ((1, 100), (BUCKET, 100)):
        pixels = rng.integers(0, 256, (bucket, size, size, 3), dtype=np.uint8)
        qs = ["what color is the cat"] * bucket
        for _ in range(3):
            engine.predict_probs_from_pixels(pixels, qs)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            engine.predict_probs_from_pixels(pixels, qs)  # ends in a device->host copy
            times.append(time.perf_counter() - t0)
        times.sort()
        out[bucket] = dict(
            pairs_per_s=bucket * iters / sum(times),
            p50_ms=1e3 * statistics.median(times),
            p90_ms=1e3 * times[int(0.9 * (iters - 1))], samples=iters)
        log(f"bucket {bucket}: {out[bucket]['pairs_per_s']:.1f} pairs/s, latency p50 "
            f"{out[bucket]['p50_ms']:.3f} ms, p90 {out[bucket]['p90_ms']:.3f} ms "
            f"({iters} calls)")
    return out


def profile(torch, engine, rng) -> None:
    """Device time by kernel over 5 forwards at bucket 32."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    size = engine.model.config.image_size
    pixels = rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)
    qs = ["what color is the cat"] * BUCKET
    engine.predict_probs_from_pixels(pixels, qs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            engine.predict_probs_from_pixels(pixels, qs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"profile: 5 forwards at bucket {BUCKET}, wall {wall * 1e3:.3f} ms "
        f"(profiler on), device busy {busy_us / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        log(f"  {e.self_device_time_total / 1e3 / 5:9.4f} ms/forward  "
            f"x{e.count // 5:<4d} {e.key[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler breakdown of the bucket-32 forward")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.models import count_parameters
    from vqa_tpu_torch.ops import _build
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import ModelConfig

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s ({_build.library_path()})")

    rng = np.random.default_rng(args.seed)
    # loading the engine on the card also turns TF32 off (f32 throughout)
    engine = VQAInference(model_config=ModelConfig(), device="cuda", seed=args.seed).load()
    n_params = count_parameters(engine.model)["total"]
    log(f"engine: full width, {n_params:,} parameters")
    require(n_params == 19_310_316, f"parameter count {n_params}")

    with torch.no_grad():
        kernels = check_kernels(torch, engine, rng)

    ops.reset_launch_counts()
    forwards = drive_main_path(engine, rng)
    launches = ops.launch_counts()
    log(f"main path: {forwards} forwards, kernel launches {launches}")
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[name] == per_forward * forwards,
                f"{name} launched {launches[name]} times in {forwards} forwards "
                f"(expected {per_forward} per forward)")
        kernels[name]["launches"] = launches[name]

    compare_whole_model(torch, engine, rng)
    tput = throughput(engine, rng)
    if args.profile:
        profile(torch, engine, rng)

    log(json.dumps({"engine": {
        "params": n_params, "build_s": build_s,
        "pairs_per_s_bucket1": tput[1]["pairs_per_s"],
        "pairs_per_s_bucket32": tput[BUCKET]["pairs_per_s"],
        "p50_ms_bucket1": tput[1]["p50_ms"], "p90_ms_bucket1": tput[1]["p90_ms"],
        "p50_ms_bucket32": tput[BUCKET]["p50_ms"],
        "p90_ms_bucket32": tput[BUCKET]["p90_ms"]}}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: ({"name": name, **r}[k]) for k in keys}
                                for name, r in kernels.items()]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
