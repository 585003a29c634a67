#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

What it does, failing (non-zero exit, no result line) on any failed check:

1. prints the card (name and power limit from nvidia-smi) and builds the
   CUDA kernels from ``vqa_tpu_torch/csrc`` with nvcc, timing the build;
2. builds the serving engine at full width (19,310,316 parameters, seeded
   random weights) and, at the main path's shapes for batch bucket 32
   (cross-attention on head-transposed views, as the model passes them),
   holds each kernel against its plain PyTorch version on the card and
   times kernel, plain version and — where one PyTorch call computes the
   same function — that call as a yardstick the port never uses; for each
   SE stage it logs the launch plan (cluster size, resident or streaming,
   split by rows or channels, shared memory, clusters the card holds at
   once) and the stage's bound;
3. zeroes the kernels' launch counters, drives the main path through the
   engine's entry points (warmup of every bucket, ``predict`` on PNG
   bytes, ``predict_batch`` / ``predict_batch_raw`` of 5 and 40 requests,
   ``attention_map``), checks shapes, finiteness and that probability rows
   sum to 1, and checks that every forward launched the stem, SE and
   cross-attention kernels 1, 4 and 2 times;
4. compares whole-model logits through the kernels with the same model
   through the plain versions, on the card (max abs error <= 1e-3);
5. measures pairs/s through ``predict_probs_from_pixels`` at buckets 1
   and 32;
6. HTTP (the serving stack on the same engine): times
   ``dispatch_probs_from_pixels`` at bucket 32 on the host against the
   forward on the card; starts ``VQAServer`` on 127.0.0.1, GETs every
   endpoint, posts /predict from 16 clients x 8 requests (PNG and JPEG of
   mixed sizes) and holds every answer within 1e-4 of the engine on that
   request alone, requires the micro-batcher to have grouped them, posts
   /predict-batch (40 images) against ``engine.predict_batch``,
   /attention, a 413, then drains with 8 requests in flight; the kernel
   launches over the phase must be 1, 4 and 2 per forward;
7. ASGI: ``create_asgi_app`` over the raw protocol (/predict, a 413 on a
   streamed body, lifespan);
8. load: ``vqa_tpu_torch/tools/load_bench.py`` at its defaults (8 clients
   x 25 /predict) against a full-width server;
9. supervisor: ``python -m vqa_tpu_torch.serving.supervisor`` with
   full-width workers on the card and a recycle bound below one worker's
   RSS; a client posts without pause through the first recycle, then the
   supervisor gets SIGTERM: no failed request, exit 0, no worker left.

All times are per forward at bucket 32 (the stem runs once, SE four
times at the four stage shapes, cross-attention twice). ``ms`` is device
time from a torch.profiler trace of repeated calls (inputs resident in L2
where they fit); the per-call time from CUDA events, which includes the
host's launch overhead where that is the slower side, is logged beside it.
The bound of each kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for the route that keeps the f32 contract, from the published
H100 SXM peaks: f32 outside the tensor cores (67 TFLOP/s) for SE and
cross-attention; for the stem's conv, 3xTF32 on the tensor cores (three
TF32 products per f32 product at 495 TFLOP/s, so 165 TFLOP/s of f32-accurate
work), the fastest f32-accurate route the card has and the one the stem
kernel takes.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one JSON line of per-kernel
numbers, and before that the ``serving`` line (load bench, HTTP phase,
supervisor) and the ``engine`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM, TF32 on the tensor cores, dense
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
    # a profiler window now and then records no device activity at all
    # (seen once in a dozen runs on the H100); such a window is retried
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in device_events(prof))
        if busy_us > 0:
            return busy_us / 1e3 / iters, call_ms
        log("profiler window saw no device time; retrying")
    raise SystemExit("chip_smoke: FAILED: the profiler saw no device time in 3 windows")


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
    conv_flops = 2 * BUCKET * ch * ch * cout * 147
    nbytes = 4 * (x.numel() + w.numel() + 2 * cout + got.numel())
    # 3xTF32: three tensor-core products per f32-accurate product
    t_ops = 3 * conv_flops / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bnd, by = max(t_ops, t_bytes), ("operations (3xTF32)" if t_ops >= t_bytes else "bytes")
    f32_bnd, _ = bound_ms(nbytes, conv_flops + 3 * BUCKET * ch * ch * cout + 8 * got.numel())
    log(f"stem bound: {bnd:.4f} ms ({by}); on the f32 CUDA cores it would be "
        f"{f32_bnd:.4f} ms")
    (k_ms, k_call), (p_ms, p_call) = (
        time_ms(torch, lambda: ops.fused_stem(x, w, scale, bias), 20),
        time_ms(torch, lambda: ops.plain_stem(x, w, scale, bias), 20))
    results["stem"] = dict(
        route="cuda", source="vqa_tpu_torch/csrc/stem.cu",
        replaces="vqa_tpu/ops/stem_kernel.py:141", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, call_ms=k_call, plain_call_ms=p_call,
        bound_ms=bnd, bound_by=by, library_ms=None)

    # ---- SE, at the four stage shapes ---------------------------------
    from vqa_tpu_torch.ops.se_kernel import max_active_clusters, se_plan

    se = dict(route="cuda", source="vqa_tpu_torch/csrc/se.cu",
              replaces="vqa_tpu/ops/se_kernel.py:50", max_abs_err=0.0, ms=0.0,
              plain_ms=0.0, call_ms=0.0, plain_call_ms=0.0, library_ms=None)
    se_bytes = se_flops = 0
    for i, (hw, c) in enumerate(SE_STAGES, start=1):
        mod = getattr(model.image_encoder, f"stage{i}").attention.se
        w1, w2 = mod.fc1.weight, mod.fc2.weight
        r = w1.shape[0]
        xs = torch.relu(torch.from_numpy(
            rng.standard_normal((BUCKET, hw, hw, c)).astype(np.float32)).to(dev))
        plan = se_plan(BUCKET, hw * hw, c, r)
        active = max_active_clusters(plan, hw * hw, c, r)
        full = plan.block_rows(hw * hw)
        mode = ("resident" if plan.keep_rows == full else "streaming" if not plan.keep_rows
                else f"{plan.keep_rows} of {full} rows kept, the rest streamed")
        log(f"se stage{i} plan: cluster {plan.cluster}, {mode}, split by "
            f"{'rows' if plan.rows else 'channels'}, "
            f"{plan.smem_bytes} bytes of shared memory per block, "
            f"{active} clusters resident at once for {BUCKET} images"
            f"{'' if active >= BUCKET else ' (more than one wave)'}")
        got, want = ops.fused_se(xs, w1, w2), ops.plain_se(xs, w1, w2)
        torch.cuda.synchronize()
        err = max_err(got, want)
        log(f"se stage{i} {tuple(xs.shape)} r={r}: max abs err {err:.3e} (tol 1e-3)")
        require(torch.allclose(got, want, atol=1e-3, rtol=1e-3), f"se stage{i} disagrees")
        se["max_abs_err"] = max(se["max_abs_err"], err)
        k_ms, k_call = time_ms(torch, lambda: ops.fused_se(xs, w1, w2), 50)
        p_ms, p_call = time_ms(torch, lambda: ops.plain_se(xs, w1, w2), 50)
        nbytes = 4 * (2 * xs.numel() + w1.numel() + w2.numel())
        flops = 2 * xs.numel() + 4 * BUCKET * c * r + 4 * BUCKET * c
        stage_bound, _ = bound_ms(nbytes, flops)
        log(f"se stage{i}: kernel {k_ms:.4f} ms on the device ({k_call:.4f} ms per "
            f"call), plain {p_ms:.4f} ms ({p_call:.4f} ms per call), bound "
            f"{stage_bound:.4f} ms")
        se["ms"] += k_ms
        se["plain_ms"] += p_ms
        se["call_ms"] += k_call
        se["plain_call_ms"] += p_call
        se_bytes += nbytes
        se_flops += flops
    se["bound_ms"], se["bound_by"] = bound_ms(se_bytes, se_flops)
    results["se"] = se

    # ---- cross-attention, both fusion layers -------------------------
    cfg = model.config
    heads, dh = cfg.num_attention_heads, cfg.embed_dim // cfg.num_attention_heads
    lq, lkv = cfg.max_question_length, cfg.feature_spatial_size ** 2
    nlayers = cfg.num_cross_layers

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # as the main path gives them: [B,H,L,d] views of [B,L,H,d] projections
    q, k, v = (randn(BUCKET, n, heads, dh).transpose(1, 2) for n in (lq, lkv, lkv))
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


def image_bytes(rng, h, w, fmt="PNG") -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, fmt)
    return buf.getvalue()


def drive_main_path(engine, rng):
    """The serving calls a user makes; returns the number of forwards."""
    questions = ["what color is the cat", "how many dogs are there", "is this a man",
                 "what is the woman wearing", "what is on the table"]
    n_classes = engine.model.config.num_answers
    forwards = 0

    engine.warmup()
    forwards += len(engine.cfg.batch_buckets)

    img = image_bytes(rng, 240, 320)
    single = engine.predict(img, questions[0], top_k=5)
    forwards += 1
    require(len(single["answers"]) == 5 and math.isfinite(single["confidence"]),
            f"predict returned {single}")
    probs = [a["probability"] for a in single["answers"]]
    require(probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1 + 1e-5,
            "predict's top-5 are not sorted probabilities")

    for n in (5, 40):
        images = [image_bytes(rng, int(h), int(w)) for h, w in rng.integers(64, 400, (n, 2))]
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


HTTP_QUESTIONS = ["what color is the cat", "how many dogs are there", "is this a man",
                  "what is the woman wearing", "what is on the table"]


def multipart(fields, files):
    """(body, content type) of a multipart/form-data request; ``files`` is
    a list of (field, filename, bytes)."""
    boundary = "XCHIPSMOKEX"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
             .encode() for k, v in fields.items()]
    parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{fn}"'
              f"\r\nContent-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n"
              for k, fn, data in files]
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def http_request(port, method, path, body=None, headers=None, conn=None):
    """(status, body bytes) of one request, on ``conn`` or a new connection."""
    import http.client

    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        if own:
            conn.close()


def check_answer(got, want_row, what: str) -> bool:
    """A /predict payload against the engine's probability row for the same
    request alone: top-5 sorted, each probability within 1e-4 of the row's,
    and the top answer the row's (up to a tie within 2e-4). Returns
    whether the top answers are exactly the same."""
    require(got.get("success") is True, f"{what}: {got.get('error')}")
    answers = got["answers"]
    probs = [a["probability"] for a in answers]
    require(len(answers) == 5 and probs == sorted(probs, reverse=True),
            f"{what}: answers {answers}")
    for a in answers:
        err = abs(a["probability"] - float(want_row[a["index"]]))
        require(err <= 1e-4, f"{what}: answer {a['index']} off by {err:.3e} (tol 1e-4)")
    require(abs(got["confidence"] - float(want_row.max())) <= 1e-4,
            f"{what}: confidence {got['confidence']} vs {want_row.max()}")
    require(float(want_row[answers[0]["index"]]) >= float(want_row.max()) - 2e-4,
            f"{what}: top answer {answers[0]['index']} is not the request's own")
    return answers[0]["index"] == int(want_row.argmax())


def dispatch_timing(torch, engine, rng, iters: int = 12) -> dict:
    """Host ms of ``dispatch_probs_from_pixels`` at bucket 32 against the
    forward's device ms: whether dispatch returns before the card finishes.
    Each round also dispatches with the inputs copied from pageable memory
    instead of the engine's pinned staging, the two in alternating order."""
    size = engine.model.config.image_size
    pixels = rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)
    qs = [HTTP_QUESTIONS[i % 5] for i in range(BUCKET)]
    device_ms, _ = time_ms(torch, lambda: engine.dispatch_probs_from_pixels(pixels, qs), iters)

    def pageable(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(engine.device) for a in arrays]

    times = {k: [] for k in ("alone", "wait", "behind", "alone_pageable", "behind_pageable")}
    for i in range(iters):
        for suffix in ("", "_pageable")[::1 if i % 2 else -1]:
            with (mock.patch.object(engine, "_to_device", pageable) if suffix
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.dispatch_probs_from_pixels(pixels, qs)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                engine.dispatch_probs_from_pixels(pixels, qs)
                t3 = time.perf_counter()  # the next one is issued with the card busy
                engine.dispatch_probs_from_pixels(pixels, qs)
                t4 = time.perf_counter()
                torch.cuda.synchronize()
            times["alone" + suffix].append(t1 - t0)
            times["behind" + suffix].append(t4 - t3)
            if not suffix:
                times["wait"].append(t2 - t1)
    med = {k: 1e3 * statistics.median(v) for k, v in times.items()}
    out = dict(dispatch_host_ms=med["alone"], sync_wait_after_dispatch_ms=med["wait"],
               dispatch_host_ms_card_busy=med["behind"],
               pageable_dispatch_host_ms=med["alone_pageable"],
               pageable_dispatch_host_ms_card_busy=med["behind_pageable"],
               forward_device_ms=device_ms)
    log(f"dispatch at bucket {BUCKET}: host {med['alone']:.3f} ms alone, {med['behind']:.3f} "
        f"ms issued behind a running forward (pageable copies: {med['alone_pageable']:.3f} / "
        f"{med['behind_pageable']:.3f} ms); the card ran {med['wait']:.3f} ms more after a "
        f"lone dispatch returned; forward {device_ms:.3f} ms on the device "
        f"(medians of {iters})")
    return out


def drive_http(torch, engine, rng) -> dict:
    """The port's HTTP server on the same engine: every endpoint, 16
    concurrent /predict clients through the micro-batcher, /predict-batch,
    /attention, 413, and a drain with requests in flight. Kernel launches
    are counted over the phase (the server's own warmup excluded)."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.serving.server import VQAServer

    n_clients, per_client = 16, 8
    reqs = []
    for i in range(n_clients * per_client):
        h, w = (int(v) for v in rng.integers(64, 400, 2))
        fmt = ("PNG", "JPEG")[i % 2]
        reqs.append((image_bytes(rng, h, w, fmt), fmt, HTTP_QUESTIONS[i % 5]))
    # each request's answer from the engine alone (bucket 1)
    want = [engine.predict_batch_raw([img], [q])[0] for img, _, q in reqs]
    batch = [(image_bytes(rng, int(h), int(w), "PNG"), HTTP_QUESTIONS[i % 5])
             for i, (h, w) in enumerate(rng.integers(64, 400, (40, 2)))]
    want_batch = engine.predict_batch([b for b, _ in batch], [q for _, q in batch])
    timing = dispatch_timing(torch, engine, rng)

    server = VQAServer(engine=engine)  # warms every bucket, as the CLI does
    thread = threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True)
    thread.start()
    while server._httpd is None:
        time.sleep(0.01)
    port = server._httpd.server_address[1]
    ops.reset_launch_counts()

    for path in ("/", "/health", "/model-info", "/metrics", "/metrics?format=prometheus",
                 "/app"):
        status, body = http_request(port, "GET", path)
        require(status == 200, f"GET {path}: {status}")
        if path == "/model-info":
            info = json.loads(body)
            require(info["device"] == "gpu" and info["total_parameters"] == 19_310_316,
                    f"/model-info: {info}")
        if path.endswith("prometheus"):
            require(b"vqa_requests_total" in body, "prometheus text")
    require(http_request(port, "GET", "/nope")[0] == 404, "GET /nope is not 404")

    results = [None] * len(reqs)

    def client(c):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        for k in range(c * per_client, (c + 1) * per_client):
            img, fmt, q = reqs[k]
            body, ctype = multipart({"question": q, "top_k": "5"},
                                    [("image", f"x.{fmt.lower()}", img)])
            status, out = http_request(port, "POST", "/predict", body,
                                       {"Content-Type": ctype}, conn)
            results[k] = (status, json.loads(out))
        conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a /predict client hung")
    same_top = 0
    for k, (status, out) in enumerate(results):
        require(status == 200, f"/predict {k}: HTTP {status}")
        same_top += check_answer(out, want[k], f"/predict {k}")
    batches = server.batcher.total_batches
    require(batches < len(reqs), f"{len(reqs)} requests in {batches} batches: never grouped")
    log(f"/predict: {len(reqs)} requests from {n_clients} clients in {wall:.3f} s, "
        f"{batches} batches (mean group {len(reqs) / batches:.2f}); every answer within "
        f"1e-4 of the request alone, top answer identical in {same_top}")

    body, ctype = multipart({"questions": ",".join(q for _, q in batch)},
                            [("images", f"{i}.png", b) for i, (b, _) in enumerate(batch)])
    status, out = http_request(port, "POST", "/predict-batch", body, {"Content-Type": ctype})
    out = json.loads(out)
    require(status == 200 and out["success"] and len(out["predictions"]) == len(batch),
            f"/predict-batch: {status} {str(out)[:300]}")
    for got, exp in zip(out["predictions"], want_batch):
        require([a["index"] for a in got["answers"]] == [a["index"] for a in exp["answers"]]
                and all(abs(a["probability"] - b["probability"]) <= 1e-4
                        for a, b in zip(got["answers"], exp["answers"])),
                "/predict-batch disagrees with engine.predict_batch")
    batch_chunks = -(-len(batch) // engine.cfg.batch_buckets[-1])

    body, ctype = multipart({"question": HTTP_QUESTIONS[0]}, [("image", "a.png", reqs[1][0])])
    status, out = http_request(port, "POST", "/attention", body, {"Content-Type": ctype})
    att = json.loads(out)
    s = engine.model.config.feature_spatial_size
    maps = np.asarray(att["attention"]["maps"])
    require(status == 200 and att["success"] and maps.shape == (len(att["attention"]["tokens"]), s, s)
            and np.allclose(maps.sum((1, 2)), 1, atol=1e-4), f"/attention: {str(att)[:300]}")
    attention_calls = 1
    body, ctype = multipart({"question": "what"}, [("image", "a.png", reqs[1][0])])
    require(http_request(port, "POST", "/attention", body, {"Content-Type": ctype})[0] == 400,
            "a one-word question is not a 400")
    status, _ = http_request(port, "POST", "/predict", b"x" * 1024, {
        "Content-Type": "multipart/form-data; boundary=B",
        "Content-Length": str((server.cfg.max_body_mb + 1) * 1024 * 1024)})
    require(status == 413, f"an oversized body gave {status}, not 413")

    # drain with requests in flight: their decode is held until drain has begun
    n_drain = 8
    release = threading.Event()
    decode = engine._preprocess_images
    drained = [None] * n_drain

    def held_decode(images):
        release.wait(30)
        return decode(images)

    def late_client(i):
        img, fmt, q = reqs[i]
        body, ctype = multipart({"question": q}, [("image", f"x.{fmt.lower()}", img)])
        status, out = http_request(port, "POST", "/predict", body, {"Content-Type": ctype})
        drained[i] = (status, json.loads(out))

    with mock.patch.object(engine, "_preprocess_images", held_decode):
        threads = [threading.Thread(target=late_client, args=(i,)) for i in range(n_drain)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while server._inflight < n_drain and time.monotonic() < deadline:
            time.sleep(0.005)
        require(server._inflight == n_drain, f"{server._inflight} of {n_drain} in flight")
        drainer = threading.Thread(target=server.drain, kwargs={"timeout": 60})
        drainer.start()
        time.sleep(0.2)
        release.set()
        drainer.join(timeout=90)
        for t in threads:
            t.join(timeout=60)
    require(not drainer.is_alive() and not any(t.is_alive() for t in threads), "drain hung")
    for i, (status, out) in enumerate(drained):
        require(status == 200, f"request {i} in flight at drain: HTTP {status}")
        check_answer(out, want[i], f"request {i} in flight at drain")
    thread.join(timeout=10)
    try:
        http_request(port, "GET", "/health")
        require(False, "the listener still answers after drain")
    except OSError:
        pass
    log(f"drain: {n_drain} requests in flight, all answered; listener closed")

    launches = ops.launch_counts()
    forwards = server.batcher.total_batches + batch_chunks + attention_calls
    log(f"HTTP phase: {forwards} forwards ({server.batcher.total_batches} batcher groups, "
        f"{batch_chunks} /predict-batch chunks, {attention_calls} /attention), "
        f"kernel launches {launches}")
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[name] == per_forward * forwards,
                f"HTTP phase: {name} launched {launches[name]} times in {forwards} forwards")
    return dict(requests=len(reqs) + n_drain, batches=server.batcher.total_batches,
                mean_group=len(reqs) / batches, forwards=forwards, launches=launches,
                top_answer_identical=same_top, **timing)


def asgi_call(app, method, path, headers=(), messages=None):
    """(status, body) of one raw ASGI 3.0 http exchange."""
    import asyncio

    scope = {"type": "http", "asgi": {"version": "3.0"}, "http_version": "1.1",
             "method": method, "path": path, "raw_path": path.encode(), "query_string": b"",
             "headers": [(k.encode(), v.encode()) for k, v in headers]}
    incoming = list(messages or [{"type": "http.request", "body": b"", "more_body": False}])
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(message):
        sent.append(message)

    asyncio.run(app(scope, receive, send))
    start = next(m for m in sent if m["type"] == "http.response.start")
    return start["status"], b"".join(m.get("body", b"") for m in sent
                                     if m["type"] == "http.response.body")


def drive_asgi(engine, rng) -> None:
    """The ASGI app over the raw protocol: /predict, a 413 on a streamed
    body without Content-Length, and lifespan."""
    import asyncio

    from vqa_tpu_torch.serving.fastapi_app import create_asgi_app
    from vqa_tpu_torch.serving.server import VQAServer
    from vqa_tpu_torch.utils.config import InferenceConfig

    server = VQAServer(engine=engine, preload=False, config=InferenceConfig(max_body_mb=1))
    app = create_asgi_app(server=server)
    try:
        img = image_bytes(rng, 224, 224, "JPEG")
        want = engine.predict_batch_raw([img], [HTTP_QUESTIONS[1]])[0]
        body, ctype = multipart({"question": HTTP_QUESTIONS[1]}, [("image", "x.jpg", img)])
        status, out = asgi_call(app, "POST", "/predict", [
            ("content-type", ctype), ("content-length", str(len(body)))],
            [{"type": "http.request", "body": body, "more_body": False}])
        require(status == 200, f"ASGI /predict: {status}")
        check_answer(json.loads(out), want, "ASGI /predict")
        big = b"x" * (1024 * 1024 + 4096)
        chunks = [{"type": "http.request", "body": big[i:i + 256 * 1024],
                   "more_body": i + 256 * 1024 < len(big)}
                  for i in range(0, len(big), 256 * 1024)]
        status, out = asgi_call(app, "POST", "/predict", [("content-type", ctype)], chunks)
        require(status == 413, f"ASGI streamed oversize body: {status}")
        incoming = [{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}]
        sent = []

        async def receive():
            return incoming.pop(0)

        async def send(message):
            sent.append(message)

        asyncio.run(app({"type": "lifespan"}, receive, send))
        require(sent == [{"type": "lifespan.startup.complete"},
                         {"type": "lifespan.shutdown.complete"}], f"lifespan: {sent}")
    finally:
        server.batcher.shutdown()
    log("ASGI: /predict answered as the engine alone, streamed 413, lifespan acknowledged")


def drive_load(torch, engine) -> dict:
    """``tools/load_bench`` at its defaults (8 clients x 25 /predict,
    224 px JPEGs, a 5 ms window) against a full-width server."""
    from vqa_tpu_torch.serving.server import VQAServer
    from vqa_tpu_torch.tools import load_bench
    from vqa_tpu_torch.utils.config import InferenceConfig

    from torch.profiler import ProfilerActivity, profile

    runs = []
    for profiled in (False, True):
        server = VQAServer(engine=engine, config=InferenceConfig(batch_timeout_ms=5.0))
        with profile(activities=[ProfilerActivity.CUDA]) if profiled else \
                contextlib.nullcontext() as prof:
            runs.append(load_bench.bench(server))
            torch.cuda.synchronize()
        r = runs[-1]
        require(r["errors"] == 0 and r["requests_ok"] == 8 * 25,
                f"load bench: {r['requests_ok']} ok, {r['errors']} errors {r['error_samples']}")
    result, again = runs
    # the second run, under a CUDA-only profiler: the card's busy share of
    # the clients' wall time (two warm-up requests before it are counted in)
    busy_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    result["profiled_run"] = dict(
        p50_ms=again["p50_ms"], p99_ms=again["p99_ms"], throughput_rps=again["throughput_rps"],
        batches=again["server_metrics"]["batches"], device_busy_ms=busy_ms,
        device_busy_share=busy_ms / 1e3 / again["wall_s"])
    log(f"load bench again under the profiler: p50 {again['p50_ms']:.3f} ms, "
        f"{again['throughput_rps']:.1f} requests/s; the card busy {busy_ms:.3f} ms of "
        f"{again['wall_s'] * 1e3:.3f} ms ({100 * busy_ms / 1e3 / again['wall_s']:.1f}%)")
    result["device"] = torch.cuda.get_device_name(engine.device)
    return result


def proc_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def drive_supervisor(rng, recycle_rss_mb: float = 512.0, worker_args=("--device", "cuda")
                     ) -> dict:
    """``python -m vqa_tpu_torch.serving.supervisor`` with full-width
    workers on the card and a recycle bound below one worker's RSS: a
    client posts /predict without pause (reconnecting on a closed
    connection, as HTTP/1.1 clients do) until the first recycle is done;
    then SIGTERM. No request may fail, the supervisor must exit 0, and no
    worker may remain."""
    import http.client
    import signal

    from vqa_tpu_torch.serving.supervisor import rss_mb

    cmd = [sys.executable, "-m", "vqa_tpu_torch.serving.supervisor", "--host", "127.0.0.1",
           "--port", "0", "--recycle-rss-mb", str(recycle_rss_mb), *worker_args,
           "--check-interval", "2", "--ready-timeout", "300"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    events, got_event = [], threading.Condition()

    def pump():
        for line in proc.stdout:
            log(f"  supervisor| {line.rstrip()}")
            if line.startswith('{"supervisor"'):
                with got_event:
                    events.append(json.loads(line))
                    got_event.notify_all()

    threading.Thread(target=pump, daemon=True).start()

    def wait_for(kind, timeout):
        with got_event:
            got_event.wait_for(lambda: any(e["supervisor"] == kind for e in events)
                               or proc.poll() is not None, timeout)
            found = [e for e in events if e["supervisor"] == kind]
        require(bool(found), f"supervisor: no {kind} event ({proc.poll()=})")
        return found[0]

    stop, counts = threading.Event(), {"ok": 0, "failed": 0, "retries": 0}
    try:
        ready = wait_for("ready", 300)
        port, first_pid = ready["port"], ready["pid"]
        rss_ready = rss_mb(first_pid)
        log(f"supervisor: worker {first_pid} ready on port {port}, RSS {rss_ready:.1f} MB")
        require(rss_ready > recycle_rss_mb, f"worker RSS {rss_ready} MB is under the bound")
        img = image_bytes(rng, 224, 224, "JPEG")
        body, ctype = multipart({"question": HTTP_QUESTIONS[0]}, [("image", "x.jpg", img)])

        def client():
            conn = None
            while not stop.is_set():
                for attempt in range(3):
                    try:
                        conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                        conn.request("POST", "/predict", body, {"Content-Type": ctype})
                        r = conn.getresponse()
                        data = r.read()
                        if r.will_close:
                            conn.close()
                            conn = None
                        ok = r.status == 200 and json.loads(data).get("success") is True
                        break
                    except (OSError, http.client.HTTPException):
                        if conn is not None:
                            conn.close()
                        conn = None
                        ok = False
                        counts["retries"] += 1
                        time.sleep(0.05 * (attempt + 1))
                counts["ok" if ok else "failed"] += 1

        client_thread = threading.Thread(target=client, daemon=True)
        client_thread.start()
        start = wait_for("recycle_start", 120)
        done = wait_for("recycle_done", 300)
        ok_at_recycle = counts["ok"]
        time.sleep(1.0)  # requests to the replacement
        stop.set()
        client_thread.join(timeout=60)
        require(not client_thread.is_alive(), "supervisor client hung")
    finally:
        stop.set()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    pids = [e["pid"] for e in events if e["supervisor"] == "spawn"]
    time.sleep(0.5)
    left = [p for p in pids if proc_alive(p)]
    log(f"supervisor: exit {rc}; {counts['ok']} requests ok ({ok_at_recycle} before the "
        f"recycle was done), {counts['failed']} failed, {counts['retries']} reconnects; "
        f"worker RSS at ready {rss_ready:.1f} MB, at recycle {start['rss_mb']} MB, "
        f"replacement at ready {done['new_rss_mb']} MB; workers left {left}")
    require(rc == 0, f"the supervisor exited {rc}")
    require(counts["failed"] == 0 and counts["ok"] > ok_at_recycle > 0,
            f"supervisor phase requests: {counts}")
    require(not left, f"workers left running: {left}")
    return dict(exit_code=rc, requests_ok=counts["ok"], requests_failed=counts["failed"],
                reconnects=counts["retries"], rss_mb_ready=rss_ready,
                rss_mb_at_recycle=start["rss_mb"], replacement_rss_mb_ready=done["new_rss_mb"],
                recycle_warmup_s=done["warmup_s"], recycle_drain_s=done["drain_s"])


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
    from vqa_tpu_torch.ops.cross_attention_kernel import smem_bytes
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
    cfg = ModelConfig()
    log(f"dynamic shared memory per block: stem "
        f"{_build.load_library().vqa_stem_smem_bytes()} bytes, cross-attention "
        f"{smem_bytes(cfg.max_question_length, cfg.feature_spatial_size ** 2, cfg.embed_dim // cfg.num_attention_heads)}"
        f" bytes at the main path's shapes")

    rng = np.random.default_rng(args.seed)
    # loading the engine on the card also turns TF32 off (f32 throughout)
    engine = VQAInference(model_config=cfg, device="cuda", seed=args.seed).load()
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

    t0 = time.perf_counter()
    http = drive_http(torch, engine, rng)
    drive_asgi(engine, rng)
    load = drive_load(torch, engine)
    log(f"load bench: {load['clients']} clients x {load['requests_per_client']} /predict, "
        f"p50 {load['p50_ms']:.3f} ms, p90 {load['p90_ms']:.3f}, p99 {load['p99_ms']:.3f}, "
        f"{load['throughput_rps']:.1f} requests/s, {load['server_metrics']['batches']} batches")
    supervisor = drive_supervisor(rng)
    log(f"serving phases: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"engine": {
        "params": n_params, "build_s": build_s,
        "pairs_per_s_bucket1": tput[1]["pairs_per_s"],
        "pairs_per_s_bucket32": tput[BUCKET]["pairs_per_s"],
        "p50_ms_bucket1": tput[1]["p50_ms"], "p90_ms_bucket1": tput[1]["p90_ms"],
        "p50_ms_bucket32": tput[BUCKET]["p50_ms"],
        "p90_ms_bucket32": tput[BUCKET]["p90_ms"]}}))
    log(json.dumps({"serving": {**load, "http": http, "supervisor": supervisor}}))
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
