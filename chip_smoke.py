#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown

What it does, failing (non-zero exit, no result line) on any failed check:

1. prints the card (name and power limit from nvidia-smi) and builds the
   CUDA kernels from ``vqa_tpu_torch/csrc`` with nvcc, timing the build;
2. builds the serving engine at full width (19,310,316 parameters, seeded
   random weights) in f32 (``dtype=torch.float32``: phases 2-8 and 10 (d)
   hold it to f32 tolerances, while the engine's default on the card is
   bf16, phase 11) and, at the main path's shapes for batch bucket 32
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
   full-width workers on the card (each serving the default engine, bf16)
   and a recycle bound below one worker's
   RSS; a client posts without pause through the first recycle, then the
   supervisor gets SIGTERM: no failed request, exit 0, no worker left;
10. training, at full width (``ModelConfig()``, 224 px), f32, TF32 off:
    (a) one train step from the same weights and synthetic batch of 32
    (dropout off) on the card and on the CPU — loss within 1e-4; with
    cuDNN off, clipped gradients and BN statistics per tensor within 10x
    the CPU's own f32 noise (the step in other summation orders) plus
    floors; with cuDNN, BN statistics within 1e-3 and the gradients as a
    whole within 10x that noise; parameters within 2·lr (a first AdamW
    step is near a sign function); (b) the Trainer's step overfits one batch of 32
    (loss halved in 30 steps at lr 1e-3); (c) ``python -m
    vqa_tpu_torch.training.train --synthetic --epochs 1 --device-aug
    --no-bf16`` (f32, which (d) and phase 11 (e) hold to f32 tolerances),
    run in this process to count kernel launches: none in train steps
    (training mode takes the plain paths), 1, 4 and 2 per validation
    forward, ``latest`` and ``best_model`` written with sidecars; (d) the
    f32 engine serves that checkpoint, its probabilities within 1e-5 of the
    trainer's eval forward; (e) a Trainer resumed from ``latest`` takes the
    same first step of epoch 1 as the uninterrupted one; (f) train pairs/s
    and ms per step at batch 32 and 256 (CUDA events over 12 steady steps,
    the card's busy share from a profiler window, peak memory);
11. bf16 serving and evaluation, at full width: (a) the bf16 forms of the
    stem, SE and cross-attention kernels against their bf16 plain versions
    at the bucket-32 shapes, within one bf16 ulp per element, timed beside
    their bf16 bounds (bytes over 3.35 TB/s or operations over 989 TFLOP/s)
    and, for cross-attention, SDPA in bf16; SE per stage with its plan and
    bound (kept in the kernel's JSON entry under ``stages``), and at 448 px
    with part of the rows streamed and with every row streamed;
    cross-attention's launch geometry held to ``bf16_geometry``; the stem also at buckets 1 and
    8, each with its launch plan (``stem_plan``; the library's shared
    memory must match it, and the engine's stem must take the TMA route)
    and cuDNN's bf16 channels_last conv alone as a yardstick (conv only,
    not the same function); (b) the default engine, bf16 on
    the card: each request's spread over buckets 1-32 measured first (cuDNN
    may take another algorithm per batch size), then phase 3's entry
    points with the bf16 forms launched 1, 4 and 2 times per forward and
    the f32 forms not at all, a request alone within twice that spread (at
    least 1e-4) of the same request in a padded batch, attention rows
    summing to 1 within 3 * 2^-9 (bf16 probabilities, averaged in bf16);
    its logits through the kernels no further from its bf16 plain versions
    than those are from the f32 engine's, and the argmax equal to f32's on
    every row whose f32 margin exceeds twice that bf16 noise; (c) pairs/s
    and p50/p90 at buckets 1 and 32 beside phase 5's f32, and both
    forwards' device ms; (d) 8 HTTP clients x 4 /predict on the bf16
    engine, every answer within the tolerance of (b); (e) ``python -m
    vqa_tpu_torch.training.evaluate --synthetic`` on phase 10's checkpoint
    in f32 and ``--bf16``: f32 top-1 equal to the trainer's validation,
    each evaluation forward launching the f32 or the bf16 forms 1, 4 and 2
    times, the artifacts written;
12. bf16 training at full width: (a) one bf16 train step on the card
    against the same step on the CPU (batch 8, dropout off), each beside
    its f32 step: per tensor, clipped gradients and BN statistics within
    twice the CPU's own bf16 noise plus floors (a stated few tensors within
    four times it), the card's own noise at most twice the CPU's,
    parameters within 2·lr;
    (b) ``python -m vqa_tpu_torch.training.train --synthetic --epochs 12
    --batch-size 64 --subset-size 2000 --device-aug --num-workers 4`` (bf16,
    the default on the card) in this process: no kernel in any train step,
    each validation forward launching the bf16 forms 1, 4 and 2 times and
    the f32 forms none, val top-1 and top-5 and seconds per epoch, best
    val top-1 >= 0.70 (JAX on its chip: 0.8025), then ``evaluate
    --synthetic --bf16`` on its best_model; (c) bf16 train ms per step,
    pairs/s, busy share and peak memory at batch 32 and 256 beside phase 10
    (f)'s f32; (d) remat none, stages and full at batch 256 in bf16 from
    the same weights and dropout masks, the first step with deterministic
    cuDNN: its loss equal to none's, its clipped gradients and BN
    statistics within 1e-6 (bit equality logged), BN counted once, ms per step and peak
    memory; (e) a batch with one NaN pixel stops a ``debug_nans`` step with
    FloatingPointError; (f) one f32 step with ``stem_s2d`` against the
    same step without it: the loss within 1e-5, the rest held as phase 10
    (a) holds the card's step as the trainer runs it, to the noise of the
    plain step on the batch in another order and with cuDNN off;
13. multi-device at full width, each rank a process of this script
    (``--worker``) with a hard time limit: (a) a launched world of one
    (``RANK=0 WORLD_SIZE=1``) on NCCL: the train CLI at --data-parallel 1
    --model-parallel 1 (bf16, one epoch, launch counts as (c)), one f32
    step at B = 32 on its grid against the plain step with deterministic
    cuDNN (every tensor within the plain step's own run-to-run difference),
    a bf16 B = 256 step's time on the grid beside phase 12 (c)'s; (b) two
    NCCL ranks on the one card (refused, or the right sum), then two gloo
    ranks sharing it, f32 with TF32 off: a dp2 step at global B = 32
    against the one-rank step (loss and BN statistics within 1e-5, the
    rest held as phase 10 (a) holds the card's step with cuDNN), mp2 and
    dp1×mp2 eval forwards at bucket 32 within 1e-3 of the unsharded model
    (each launching the stem, SE and cross-attention kernels 1, 4 and 2
    times, cross-attention on 4 local heads), ``evaluate --synthetic
    --data-parallel 2`` on (a)'s checkpoint with top-1 and top-5 equal to
    the one-rank evaluator's, a checkpoint saved on a 1×2 grid loaded
    strictly by a one-card engine (probabilities within 1e-5, answers
    equal); the cross-attention kernel at the grid's H = 4 against its
    plain version; (c) an engine with two replicas on cuda:0 against one
    replica (within 1e-4 at buckets 1, rounded up to 2, and 32), and
    ``server --data-parallel 2`` stopping with the mesh's named error;
14. host prep, the off-path modules and the tools, at full width: (a) the
    native resampler (``vqa_tpu_torch/native``, built with g++) bit-identical
    to PIL and to the port's PIL path at 64-1024 px, odd shapes and the
    batch path; decode + resize to 224 per image, PIL against native; 32
    uploads at 512 px, the native pool against PIL in a loop; the bf16
    engine's ``_preprocess_images`` over one bucket-32 group of the soak's
    uploads beside its dispatch host ms at bucket 32 (decode + resize as a
    share of the group's host time); (b) ``CBAMBlock`` and
    ``SelfAttention2D`` at [32,512,7,7] and [32,64,56,56] (seeded weights,
    gamma 0.5), the card's f32 forward within 1e-4 of the CPU's, CBAMBlock
    launching SE once per eval call in f32 and in bf16; (c) spatial corpora
    from ``tools/make_vqa_corpus.py`` (1,200 scenes at seed 42, 250 held out
    at 4242; the held-out one written twice, its JSON and decoded images
    equal), the train CLI on the first for 16 epochs (bf16), then
    ``tools/attention_faithfulness.py`` on the held-out one (mean
    queried-quadrant mass above the uniform 0.25, each eval forward
    launching the f32 forms 1, 4 and 2 times) and
    ``tools/visualize_attention.py`` (three PNGs); (d)
    ``tools/soak_test.py`` in this process, 2,000 requests from 16 clients
    on the bf16 engine: passed, no contract violation, no stuck waiter, RSS
    plateaued, the bf16 forms launched 1, 4 and 2 times per forward; (e)
    the soak under the recycle supervisor, 600 requests from 8 clients and
    a 512 MB bound: every request answered, a recycle begun;
15. the engine's CUDA graphs (one per bucket and replica, captured by
    ``load``: every engine forward of phases 3-14 above was a replay), the
    roofline and the supervisor's default, at full width: (a) for an f32
    and a bf16 engine, every effective bucket a graph, and the replayed
    probabilities on new inputs against the eager forward
    (``_dispatch_eager``) on the same inputs, f32 within 1e-4, bf16 by
    phase 11 (b)'s rule; (b) 70 requests in one call (three chunks, all
    dispatched before any fetch) equal to each chunk alone; (c) the
    dtype's forms launched 1, 4 and 2 times per replayed forward, the
    others not; (d) eager and graph in turns, four rounds: bucket-1 p50/p90,
    bucket-32 pairs/s, host ms of one bucket-32 dispatch, the card's busy
    share and device ms per call, each with its spread; (e) phase 13 (c)'s
    two replicas on cuda:0, each replaying graphs of its own, within 1e-4
    of one; (f) the roofline floor of a bucket-32 forward
    (``tools/roofline.py``, f32 and bf16) beside the graphed forward's
    device ms; (g) a default-flag supervisor over a full-width worker: its
    RSS at ready split by mapping, 30 s idle with no ``recycle_start``,
    exit 0 and no worker left, while a worker of this script
    (``--worker rss_stages``) builds a bf16 engine step by step and reads
    its RSS after each step;
16. the trainer's and the evaluator's CUDA graphs (one per batch shape for
    each train step, device augmentation, validation and evaluation
    forward, ``training/step_graph.py``: every Trainer of phases 10-14
    above that trained on the card over NCCL or alone was graphed, the gloo
    ranks of phase 13 (b) eager by the stated rule) and the ablation
    runner, at full width: (a) five steps at B = 32 from the same weights,
    batches and dropout generator, eagerly and graphed (two eager warm
    steps, the capture's replay, two more), deterministic cuDNN, for f32,
    bf16, ``grad_accum`` 2 and remat stages and full: the losses, the
    clipped gradients and their norm, the parameters and BN's statistics
    within 1e-6 (f32) or ``compare_bf16_steps``'s bound (bf16), the
    generator's state before each step equal; two replays on one batch at
    learning rate 0 with other losses (fresh dropout masks per replay);
    phase 13 (a)'s rank: five f32 steps graphed on the NCCL world-of-one
    mesh within the plain steps' run-to-run difference; (b) eager and graph
    in turns on one model, four rounds, bf16 and f32 at B = 32 and 256: ms
    per step, host ms per step, pairs/s, the card's busy share, peak memory
    of the eager steps and of the capture and the graph pool's size; the
    data pipeline's host ms per batch (``prefetch_to_device`` over the
    synthetic loader); (c) a bf16 Trainer's augment graph bit-equal to the
    eager augmentation, its validation graph after a trained epoch equal to
    the eager validation of the same weights and launching the bf16 forms
    1, 4 and 2 times per replay, the graphed evaluator's top-1 equal to the
    trainer's; (d) phase 12 (b)'s 12-epoch run: every train step and
    validation forward after the two warm ones a replay; (e)
    ``tools/run_ablation.py`` cut to 1 epoch on spatial corpora of 300/100
    scenes, three variants trained and evaluated in subprocesses on the
    card (each training logging its graphs), the table written, then the
    same call again running nothing;
17. the JAX trainer's Orbax checkpoint read without orbax, tensorstore or a
    zstd library, from the committed fixture ``tests/fixtures/orbax_narrow``
    (a narrow trainer tree at 224 px with its tokenizer, answer vocabulary
    and ``expected.npz``: the JAX engine's f32 probabilities for the
    requests of its ``inputs.py`` and every array's SHA-256): (a) the zstd
    decoder built with g++ from ``vqa_tpu_torch/native/zstd_decode.cc``
    (the build timed), the fixture's zarr chunks decoded in one call on one
    thread and on the pool (MB/s), and the whole read
    (``load_orbax_checkpoint``) timed, every array equal to its digest;
    (b) ``VQAInference(checkpoint_dir=fixture)`` loaded in f32 and bf16
    (ms, the graph captures included) and asked the fixture's requests:
    f32 probabilities within 1e-4 of ``expected.npz``; the bf16 engine's
    within phase 11 (b)'s bound (no further from the same model's plain
    bf16 forward than that is from f32, and the argmax of f32 on every row
    whose margin is clear of that noise), each forward launching its forms
    1, 4 and 2 times; (c) ``python -m vqa_tpu_torch.compat.torch_export``
    on the fixture, its ``.pth`` loaded by the f32 engine, the same
    answers; (d) the evaluator CLI (``--demo``) on the fixture directory.

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
kernel takes. The bf16 forms' bounds take half the bytes and the bf16
tensor-core peak (989 TFLOP/s).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit; before that, one JSON line of per-kernel
numbers for the six forms (launches counted over the f32 engine's main
path of phase 3 for the f32 forms, over the bf16 engine's of phase 11 (b)
for the bf16 ones; beside them, ``launches_bf16_training_validation``,
each form's launches over phase 12 (b)'s validation forwards, and
``launches_multi_device``, over phase 13's sharded forwards, dp2 evaluation
(rank 0) and replicas, and ``launches_tools``, over phase 14's CBAMBlock
calls, faithfulness and visualization forwards and the in-process soak's
engine, and ``launches_orbax``, over phase 17 (b)'s engine answers;
``stages``, the bf16 SE's per-stage numbers, null elsewhere); before that,
the graphed forward's device ms per bucket-32 call in f32 and bf16 (phase
15 (d), each round's); and before that the ``orbax``, ``train_graphs``,
``graphs``, ``tools``, ``multi_device``, ``bf16_training``, ``bf16``,
``training``, ``serving`` (load bench, HTTP phase, supervisor) and
``engine`` lines.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM, TF32 on the tensor cores, dense
BF16_FLOP_PER_S = 989e12    # H100 SXM, bf16 on the tensor cores, dense
BUCKET = 32
STEM_BUCKETS = (1, 8, BUCKET)  # the bf16 stem is timed at these batch buckets (phase 11 (a))
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


def drive_main_path(engine, rng, alone_tol: float = 1e-4, map_tol: float = 1e-4):
    """The serving calls a user makes; returns the number of forwards.
    ``alone_tol``: a request alone against the same request in a padded
    batch; ``map_tol``: attention map rows against a sum of 1."""
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
    require(abs(alone - float(raw[0].max())) < alone_tol,
            f"request alone {alone} vs in a padded batch {raw[0].max()} (tol {alone_tol:.1e})")

    att = engine.attention_map(img, questions[0])
    forwards += 1
    maps = np.asarray(att["attention"]["maps"])
    s = engine.model.config.feature_spatial_size
    require(maps.shape == (len(att["attention"]["tokens"]), s, s),
            f"attention maps {maps.shape}")
    require(np.isfinite(maps).all() and np.allclose(maps.sum((1, 2)), 1, atol=map_tol),
            f"attention maps do not sum to 1 over the image grid (tol {map_tol:.1e})")
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


def check_answer(got, want_row, what: str, tol: float = 1e-4) -> bool:
    """A /predict payload against the engine's probability row for the same
    request alone: top-5 sorted, each probability within ``tol`` of the
    row's, and the top answer the row's (up to a tie within 2 tol).
    Returns whether the top answers are exactly the same."""
    require(got.get("success") is True, f"{what}: {got.get('error')}")
    answers = got["answers"]
    probs = [a["probability"] for a in answers]
    require(len(answers) == 5 and probs == sorted(probs, reverse=True),
            f"{what}: answers {answers}")
    for a in answers:
        err = abs(a["probability"] - float(want_row[a["index"]]))
        require(err <= tol, f"{what}: answer {a['index']} off by {err:.3e} (tol {tol:.1e})")
    require(abs(got["confidence"] - float(want_row.max())) <= tol,
            f"{what}: confidence {got['confidence']} vs {want_row.max()}")
    require(float(want_row[answers[0]["index"]]) >= float(want_row.max()) - 2 * tol,
            f"{what}: top answer {answers[0]['index']} is not the request's own")
    return answers[0]["index"] == int(want_row.argmax())


def dispatch_timing(torch, engine, rng, iters: int = 12) -> dict:
    """Host ms of ``dispatch_probs_from_pixels`` at bucket 32 against the
    forward's device ms: whether dispatch returns before the card finishes.
    Each round also dispatches with the inputs copied from pageable memory
    instead of the engine's pinned staging (``_stage``), the two in
    alternating order."""
    size = engine.model.config.image_size
    pixels = rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)
    qs = [HTTP_QUESTIONS[i % 5] for i in range(BUCKET)]
    device_ms, _ = time_ms(torch, lambda: engine.dispatch_probs_from_pixels(pixels, qs), iters)

    def pageable(device, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]

    times = {k: [] for k in ("alone", "wait", "behind", "alone_pageable", "behind_pageable")}
    for i in range(iters):
        for suffix in ("", "_pageable")[::1 if i % 2 else -1]:
            with (mock.patch.object(engine, "_stage", pageable) if suffix
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


# The training phase's card-against-CPU step (full width, f32, TF32 off),
# also used by tests/test_torch_cuda.py. At random initialisation many
# backbone gradients are ill-conditioned (BN's backward subtracts most of
# what reaches it): two correct f32 runs of the same step on the CPU, the
# batch in another order, differ by up to a sixth of some tensors' largest
# gradient. So the card is held to the CPU's own f32 noise, measured per
# tensor as the larger difference from the CPU's step of (1) the same step
# on the batch in another order (the loss is a mean over the batch, so the
# step is the same function; only the rounding differs) and (2) the step
# without oneDNN (PyTorch's native CPU convolutions, another summation
# order). The card's step is checked twice:
# - cuDNN off (PyTorch's own CUDA convolutions and BN, IEEE f32 GEMMs): every
#   gradient tensor and BN statistic within 10x the CPU's noise plus floors;
# - as the trainer runs it (cuDNN, whose f32 convolution algorithms include
#   FFT and Winograd ones): the loss, BN statistics and parameters to the
#   bounds below, and the gradients as a whole within 10x the CPU's noise.
STEP_LOSS_TOL = 1e-4      # |loss_card - loss_cpu|
STEP_NOISE_FACTOR = 10.0  # |x_card - x_cpu| <= 10 x the CPU's noise + floors
STEP_REL_FLOOR = 1e-5     # floor: 1e-5 of the tensor's max (BN statistics: of max(1, max))
STEP_GLOBAL_FLOOR = 1e-6  # and, for gradients, 1e-6 of the model's largest gradient
STEP_CUDNN_BN_REL_TOL = 1e-3  # cuDNN: BN statistics, per tensor, of max(1, max)
# a first AdamW step moves a weight by ~lr·g/(|g| + eps), near a sign
# function of g, so parameters are held to 2·lr (+1e-6 of rounding), and
# the weights whose update changed sign are counted
TRAIN_BATCH_SIZES = (32, 256)


def synthetic_batch(cfg, batch: int, seed: int = 0):
    """A batch of ``batch`` synthetic scenes at ``cfg.image_size``
    (normalized f32 images, token ids, mask, answers), as the port's
    synthetic loader makes them."""
    from vqa_tpu_torch.data.dataset import BatchLoader
    from vqa_tpu_torch.data.synthetic import SyntheticVQADataset

    ds = SyntheticVQADataset(num_samples=batch, image_size=cfg.image_size,
                             max_question_length=cfg.max_question_length,
                             is_training=False, seed=seed)
    b = next(iter(BatchLoader(ds, batch, shuffle=False, drop_last=True)))
    return [b["image"], b["token_ids"], b["attention_mask"], b["answer"]]


def one_train_step(torch, cfg, where, arrays, lr: float, seed: int = 11, mesh=None,
                   **model_kw):
    """(model after one train step from seeded weights, its metrics);
    ``model_kw`` (``dtype``, ``stem_s2d``) go to ``create_vqa_model``; with
    ``mesh`` the model is placed on it first (``shard_model``)."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.models.vqa_model import shard_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig

    model = create_vqa_model(config=cfg, device=where, seed=seed, **model_kw)
    if mesh is not None:
        shard_model(model, mesh)
    state = TrainState.create(
        model, TrainingConfig(learning_rate=lr, warmup_epochs=0, num_epochs=3), 10)
    metrics = make_train_step(model)(state, *(torch.from_numpy(a).to(where) for a in arrays))
    return model, metrics


def compare_train_steps(torch, cpu, cpu_noise, card, lr: float) -> dict:
    """The card's step against the CPU's, bounded by the CPU's own f32
    noise: ``cpu_noise`` is a list of CPU runs of the same step in other
    summation orders. Each run is (model, metrics). Returns the errors,
    ``failures`` (per-tensor noise bounds) and ``cudnn_failures`` (the
    bounds of the step as the trainer runs it)."""
    m_cpu, r_cpu = cpu
    m_card, r_card = card
    failures = []
    loss_err = abs(float(r_card["loss"]) - float(r_cpu["loss"]))
    if loss_err > STEP_LOSS_TOL:
        failures.append(f"loss off by {loss_err:.3e}")
    for k in ("correct1", "correct5"):
        if int(r_card[k]) != int(r_cpu[k]):
            failures.append(f"{k} {int(r_card[k])} != {int(r_cpu[k])}")

    def named(model, kind):
        items = model.named_parameters() if kind == "grad" else model.named_buffers()
        return {k: (v.grad if kind == "grad" else v).detach().cpu().double()
                for k, v in items
                if kind == "grad" or k.endswith(("running_mean", "running_var"))}

    out = dict(loss_err=loss_err, loss_noise=max(
        abs(float(r["loss"]) - float(r_cpu["loss"])) for _, r in cpu_noise))
    for kind in ("grad", "bn"):
        ref, dev = named(m_cpu, kind), named(m_card, kind)
        others = [named(m, kind) for m, _ in cpu_noise]
        top = max(float(v.abs().max()) for v in ref.values())
        worst, max_rel = [], 0.0
        sq_ref, sq_err, sq_noise = 0.0, 0.0, [0.0] * len(others)
        for name, r in ref.items():
            err = float((dev[name] - r).abs().max())
            noise = max(float((o[name] - r).abs().max()) for o in others)
            scale = float(r.abs().max()) if kind == "grad" else max(1.0, float(r.abs().max()))
            bound = (STEP_NOISE_FACTOR * noise + STEP_REL_FLOOR * scale
                     + (STEP_GLOBAL_FLOOR * top if kind == "grad" else 0.0))
            worst.append((err / bound, name, err, noise, scale))
            max_rel = max(max_rel, err / max(scale, 1e-30))
            sq_ref += float((r ** 2).sum())
            sq_err += float(((dev[name] - r) ** 2).sum())
            for i, o in enumerate(others):
                sq_noise[i] += float(((o[name] - r) ** 2).sum())
        worst.sort(reverse=True)
        failures += [f"{kind} {n}: err {e:.3e} > bound (noise {z:.3e}, max {m:.3e})"
                     for f, n, e, z, m in worst if f > 1]
        out[kind] = dict(
            worst=[dict(name=n, err=e, noise=z, max=m, share_of_bound=f)
                   for f, n, e, z, m in worst[:3]],
            rel_l2_err=math.sqrt(sq_err / max(sq_ref, 1e-300)),
            rel_l2_noise=max(math.sqrt(q / max(sq_ref, 1e-300)) for q in sq_noise),
            max_rel_err=max_rel)
    card_params = dict(m_card.named_parameters())
    param_err, flipped = 0.0, 0
    for name, p in m_cpu.named_parameters():
        d = (card_params[name].detach().cpu() - p.detach().cpu()).abs()
        param_err = max(param_err, float(d.max()))
        flipped += int((d > lr).sum())
    if param_err > 2 * lr + 1e-6:
        failures.append(f"parameters off by {param_err:.3e} > 2·lr")
    out.update(param_err=param_err, params_flipped=flipped, failures=failures)
    cudnn = [f for f in failures if not f.startswith(("grad ", "bn "))]
    if out["bn"]["max_rel_err"] > STEP_CUDNN_BN_REL_TOL:
        cudnn.append(f"BN statistics off by {out['bn']['max_rel_err']:.3e}")
    g = out["grad"]
    if g["rel_l2_err"] > STEP_NOISE_FACTOR * g["rel_l2_noise"] + STEP_REL_FLOOR:
        cudnn.append(f"gradients off by {g['rel_l2_err']:.3e} (L2; CPU noise "
                     f"{g['rel_l2_noise']:.3e})")
    out["cudnn_failures"] = cudnn
    return out


def step_card_vs_cpu(torch, cfg, device, lr: float = 1e-4, batch: int = 32) -> dict:
    """(a) One train step from the same weights and synthetic batch
    (dropout off) on the CPU (three times: as is, the batch in another
    order, oneDNN off) and on the card (cuDNN off, then as the trainer
    runs it)."""
    import dataclasses

    cfg = dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)
    arrays = synthetic_batch(cfg, batch, seed=1)
    perm = np.random.default_rng(0).permutation(batch)
    runs = {}
    for name, where, data, onednn, cudnn in (
            ("cpu", "cpu", arrays, True, True),
            ("cpu_permuted", "cpu", [a[perm] for a in arrays], True, True),
            ("cpu_onednn_off", "cpu", arrays, False, True),
            ("card_cudnn_off", device, arrays, True, False), ("card", device, arrays, True, True)):
        t0 = time.perf_counter()
        with torch.backends.mkldnn.flags(enabled=onednn), torch.backends.cudnn.flags(
                enabled=cudnn, deterministic=False, benchmark=False, allow_tf32=False):
            runs[name] = one_train_step(torch, cfg, where, data, lr)
        log(f"train step, {name}: loss {float(runs[name][1]['loss']):.7f}, "
            f"{time.perf_counter() - t0:.2f} s")
    out = {}
    noise = [runs["cpu_permuted"], runs["cpu_onednn_off"]]
    for name in ("card_cudnn_off", "card"):
        r = compare_train_steps(torch, runs["cpu"], noise, runs[name], lr)
        for kind in ("grad", "bn"):
            log(f"{name} vs CPU, {kind}: relative L2 error {r[kind]['rel_l2_err']:.3e} (the "
                f"CPU's own f32 noise {r[kind]['rel_l2_noise']:.3e}), max per-tensor error "
                f"{r[kind]['max_rel_err']:.3e} of the tensor's max; nearest to the noise "
                "bound: " + "; ".join(
                    f"{w['name']} err {w['err']:.3e} noise {w['noise']:.3e} max {w['max']:.3e} "
                    f"({100 * w['share_of_bound']:.0f}%)" for w in r[kind]["worst"]))
        log(f"{name} vs CPU, one step at B={batch} (lr {lr}): loss err {r['loss_err']:.3e} "
            f"(tol {STEP_LOSS_TOL}; CPU noise {r['loss_noise']:.3e}); params max err "
            f"{r['param_err']:.3e} (tol 2·lr), {r['params_flipped']} weights whose update "
            f"changed sign")
        out[name] = r
    require(not out["card_cudnn_off"]["failures"], "train step card (cuDNN off) vs CPU: "
            + "; ".join(out["card_cudnn_off"]["failures"][:5]))
    require(not out["card"]["cudnn_failures"], "train step card vs CPU: "
            + "; ".join(out["card"]["cudnn_failures"][:5]))
    for r in out.values():
        del r["failures"], r["cudnn_failures"]
    out["lr"], out["batch"] = lr, batch
    return out


def overfit_one_batch(torch, cfg, device, steps: int = 30) -> dict:
    """(b) The Trainer's step on one batch of 32, lr 1e-3, no warmup."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import TrainingConfig

    batch = [torch.from_numpy(a).to(device) for a in synthetic_batch(cfg, 32, seed=2)]
    model = create_vqa_model(config=cfg, device=device, seed=12)
    one = [{"answer": np.zeros(32)}] * steps  # the loaders' length sets the schedule
    trainer = Trainer(model, one, [], config=TrainingConfig(
        learning_rate=1e-3, warmup_epochs=0, num_epochs=20), save_checkpoints=False)
    losses = [float(trainer.train_step(trainer.state, *batch)["loss"]) for _ in range(steps)]
    log(f"overfit one batch of 32: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {steps} "
        f"steps (min {min(losses):.4f})")
    require(all(math.isfinite(v) for v in losses), "non-finite loss while overfitting")
    require(losses[-1] < losses[0] / 2, f"loss {losses[0]} -> {losses[-1]}: not halved")
    return dict(first_loss=losses[0], last_loss=losses[-1], steps=steps)


def drive_train_cli(torch, tmp: str, extra=(), argv=None, form: str = "") -> tuple:
    """(c) ``python -m vqa_tpu_torch.training.train --synthetic --epochs 1``
    (or ``argv``), in this process so the kernel launches of each train
    epoch and each validation can be counted: no kernel in any train
    epoch; each validation forward launches the forms of ``form`` ("" f32,
    "_bf16") of the stem, SE and cross-attention 1, 4 and 2 times, and the
    other forms none. Returns (the CLI's Trainer, a summary with the
    launches and seconds of every epoch)."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.training import checkpoint as ckpt_lib
    from vqa_tpu_torch.training import train as train_mod

    seen = {"trainer": None, "epochs": []}
    train_epoch, validate = train_mod.Trainer.train_epoch, train_mod.Trainer.validate

    def replays(graphed):
        """Replays so far of a graphed call (None where it runs eagerly)."""
        return getattr(getattr(graphed, "calls", graphed), "replays", None)

    def counted_train_epoch(self, epoch):
        seen["trainer"] = self
        ops.reset_launch_counts()
        before = replays(self.train_step)
        t0 = time.perf_counter()
        out = train_epoch(self, epoch)
        seen["epochs"].append(dict(epoch=epoch, train_launches=ops.launch_counts(),
                                   train_steps=len(self.train_loader),
                                   train_s=time.perf_counter() - t0,
                                   train_replays=(None if before is None else
                                                  replays(self.train_step) - before),
                                   backend=(torch.distributed.get_backend()
                                            if torch.distributed.is_initialized() else None),
                                   world=train_mod.distributed.process_count()))
        return out

    def counted_validate(self):
        ops.reset_launch_counts()
        before = replays(self.val_step)
        t0 = time.perf_counter()
        out = validate(self)
        seen["epochs"][-1].update(val_launches=ops.launch_counts(),
                                  val_forwards=len(self.val_loader),
                                  val_s=time.perf_counter() - t0,
                                  val_replays=(None if before is None else
                                               replays(self.val_step) - before),
                                  val_top1=out["val_top1"], val_top5=out["val_top5"])
        return out

    if argv is None:
        argv = ["--synthetic", "--epochs", "1", "--subset-size", "640", "--device-aug",
                "--num-workers", "4"]
    argv = [*argv, "--checkpoint-dir", tmp, *extra]
    t0 = time.perf_counter()
    with mock.patch.object(train_mod.Trainer, "train_epoch", counted_train_epoch), \
            mock.patch.object(train_mod.Trainer, "validate", counted_validate):
        logger = train_mod.main(argv)
    wall = time.perf_counter() - t0
    trainer = seen["trainer"]
    other = "_bf16" if not form else ""
    for e in seen["epochs"]:
        log(f"train CLI epoch {e['epoch']}: {e['train_steps']} train steps in "
            f"{e['train_s']:.1f} s ({e['train_replays']} graph replays) launched "
            f"{e['train_launches']}; {e['val_forwards']} validation forwards in "
            f"{e['val_s']:.1f} s ({e['val_replays']} graph replays) launched "
            f"{e['val_launches']}; val top-1 {e['val_top1']:.4f}, top-5 {e['val_top5']:.4f}")
        require(all(v == 0 for v in e["train_launches"].values()),
                f"kernels launched during train steps: {e['train_launches']}")
        for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
            require(e["val_launches"][name + form] == per_forward * e["val_forwards"]
                    and e["val_launches"][name + other] == 0,
                    f"validation: launches {e['val_launches']} in {e['val_forwards']} forwards")
    log(f"train CLI ({' '.join(argv)}): {wall:.1f} s; history {logger.history}")
    require(all(math.isfinite(v) for vs in logger.history.values() for v in vs
                if isinstance(v, float)), "non-finite metrics")
    for name in ("latest", "best_model"):
        require(ckpt_lib.checkpoint_exists(tmp, name), f"no {name} checkpoint with sidecar")
    first = seen["epochs"][0]
    return trainer, dict(seconds=wall, train_steps=first["train_steps"],
                         train_launches=first["train_launches"],
                         val_forwards=first["val_forwards"], val_launches=first["val_launches"],
                         val_top1=logger.history["val_top1"][-1], epochs=seen["epochs"])


def engine_from_checkpoint(torch, trainer, tmp: str, rng) -> float:
    """(d) The engine loads the checkpoint just written; its probabilities
    on 8 pairs against the trainer's eval-mode forward."""
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.serving.engine import VQAInference

    engine = VQAInference(checkpoint_dir=tmp, checkpoint_name="latest",
                          device=trainer.device, dtype=torch.float32).load()
    require(engine.model_loaded_from_checkpoint, "the engine did not load the checkpoint")
    size = trainer.model.config.image_size
    pixels = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    questions = ["what color is the circle", "how many shapes are there", "is there a square",
                 "what color is the triangle"] * 2
    probs = engine.predict_probs_from_pixels(pixels, questions)
    ids, mask = engine.tokenizer.encode_batch_np(questions)
    with torch.inference_mode():
        logits, _ = trainer.model.eval()(
            device_normalize(torch.from_numpy(pixels).to(trainer.device)),
            torch.from_numpy(ids).long().to(trainer.device),
            torch.from_numpy(mask).to(trainer.device))
    want = torch.softmax(logits, -1).cpu().numpy()
    err = float(np.abs(probs - want).max())
    log(f"engine from the checkpoint: 8 pairs, max prob err {err:.3e} (tol 1e-5), "
        f"top answers {[engine.answer_vocab.decode(int(i)) for i in probs.argmax(-1)]}")
    require(err <= 1e-5, f"engine vs trainer probabilities {err}")
    require((probs.argmax(-1) == want.argmax(-1)).all(), "engine top answers differ")
    return err


def resume_matches(torch, trainer, tmp: str) -> float:
    """(e) Resume a fresh Trainer from ``latest`` and take the first step
    of epoch 1; the CLI's own Trainer (uninterrupted) takes the same step."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import Trainer

    model = create_vqa_model(config=trainer.model.config, device=trainer.device, seed=99)
    resumed = Trainer(model, trainer.train_loader, trainer.val_loader, config=trainer.cfg,
                      checkpoint_dir=tmp, seed=trainer.seed)
    resumed.resume("latest")
    require(resumed.state.step == trainer.state.step and resumed.start_epoch == 1,
            f"resumed at step {resumed.state.step}, epoch {resumed.start_epoch}")
    losses = []
    for t in (resumed, trainer):
        t.train_loader.set_epoch(1)
        batch = next(iter(t.train_loader))
        images = torch.from_numpy(batch["image"]).to(t.device)
        if images.dtype == torch.uint8:
            images = t.augment(images, 1, 0)
        torch.manual_seed(1234)  # the same dropout masks for both
        losses.append(float(t.train_step(t.state, images, *(
            torch.from_numpy(batch[k]).to(t.device)
            for k in ("token_ids", "attention_mask", "answer")))["loss"]))
    err = abs(losses[0] - losses[1])
    log(f"resume: first step of epoch 1 resumed {losses[0]:.6f}, uninterrupted "
        f"{losses[1]:.6f}, err {err:.3e} (tol {STEP_LOSS_TOL})")
    require(err <= STEP_LOSS_TOL, "resumed step differs from the uninterrupted one")
    return err


def train_timing(torch, cfg, device, batch: int, steps: int = 12, dtype=None,
                 remat: str = "none", mesh=None) -> dict:
    """(f) Train pairs/s and ms per step at ``batch`` (f32 unless ``dtype``,
    with ``remat``, on ``mesh`` when given): CUDA events over ``steps``
    steady steps after 3 warm-up steps, the device's busy share from a
    profiler window of 5 steps, and peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.models.vqa_model import shard_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig

    rng = np.random.default_rng(batch)
    size, L = cfg.image_size, cfg.max_question_length
    args = [torch.from_numpy(a).to(device) for a in (
        rng.standard_normal((batch, size, size, 3)).astype(np.float32),
        rng.integers(4, cfg.vocab_size, (batch, L)).astype(np.int32),
        np.ones((batch, L), np.int32),
        rng.integers(0, cfg.num_answers, batch).astype(np.int32))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    model = create_vqa_model(config=cfg, device=device, seed=13,
                             dtype=dtype or torch.float32)
    if mesh is not None:
        shard_model(model, mesh)
    state = TrainState.create(model, TrainingConfig(warmup_epochs=0), 100)
    step = make_train_step(model, remat=remat)
    for _ in range(3):
        step(state, *args)
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        m = step(state, *args)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    window = 5
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            m = step(state, *args)
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    peak = torch.cuda.max_memory_allocated(device)
    require(math.isfinite(float(m["loss"])), "non-finite loss in the timed steps")
    out = dict(batch=batch, step_ms=step_ms, pairs_per_s=batch / step_ms * 1e3,
               device_busy_ms_per_step=busy_ms / window,
               device_busy_share=busy_ms / wall_ms, peak_memory_bytes=peak, steps=steps,
               dtype=str(model.dtype).replace("torch.", ""), remat=remat,
               mesh=None if mesh is None else mesh.shape)
    log(f"train step at B={batch}, {out['dtype']}, remat {remat}"
        + ("" if mesh is None else f", on a {mesh.data_parallel}×{mesh.model_parallel} mesh")
        + f": {step_ms:.3f} ms "
        f"({out['pairs_per_s']:.1f} pairs/s, CUDA "
        f"events over {steps} steps); profiled window: card busy {busy_ms / window:.3f} ms "
        f"per step, {100 * out['device_busy_share']:.1f}% of the wall time; peak memory "
        f"{peak / 2**30:.2f} GiB")
    del model, state, args
    return out


def drive_training(torch, rng, tmp: str) -> dict:
    """The training phase at full width (``ModelConfig()``, 224 px), f32,
    TF32 off: (a) one step card vs CPU, (b) overfit one batch, (c) the
    train CLI with launch counts, its checkpoint written to ``tmp``, (d)
    that checkpoint in the f32 engine, (e) resume, (f) timing at batch 32
    and 256."""
    from vqa_tpu_torch.utils.config import ModelConfig

    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig()
    t0 = time.perf_counter()
    out = {"card_vs_cpu": step_card_vs_cpu(torch, cfg, device)}
    out["overfit"] = overfit_one_batch(torch, cfg, device)
    # f32 (--no-bf16): (d) and phase 11 (e) hold f32 tolerances against it
    trainer, out["cli"] = drive_train_cli(torch, tmp, extra=("--no-bf16",))
    require(trainer.model.dtype == torch.float32, f"--no-bf16 trained in {trainer.model.dtype}")
    out["engine_prob_err"] = engine_from_checkpoint(torch, trainer, tmp, rng)
    out["resume_loss_err"] = resume_matches(torch, trainer, tmp)
    del trainer
    out["timing"] = {str(b): train_timing(torch, cfg, device, b) for b in TRAIN_BATCH_SIZES}
    out["seconds"] = time.perf_counter() - t0
    log(f"training phase: {out['seconds']:.1f} s")
    return out


# ---- phase 12: bf16 training -------------------------------------------------
#
# The card's bf16 step against the CPU's bf16 step, both from the same weights
# and batch (dropout off). At random initialisation bf16 noise is large and
# lumpy: a ReLU unit whose input is near zero flips its mask in one rounding
# and not the other, which moves every gradient behind it by O(1). Each
# tensor is held, in L2, to the CPU's own bf16 noise alone (its bf16 step
# against its f32 step): twice that, plus a floor of the CPU's median
# relative noise times the tensor and phase 10 (a)'s floors. One tensor of
# each kind may pass that bound, within BF16_STEP_CAP times it, for a mask
# flip by chance (the card's readings: none past it, the nearest at 52% at
# full width and 74% at the cuda test's tiny width). What the card's rounding adds is held
# apart: its own median noise at most twice the CPU's. The loss: twice the
# CPU's own noise plus 2^-8 of it. Parameters: 2·lr (+1e-6), a first AdamW
# step being near lr·sign(g).
BF16_STEP_ALLOWED = {"grad": 1, "bn": 1}
BF16_STEP_CAP = 4.0
BF16_STEP_BATCH = 8  # full width on the CPU in bf16: a few seconds a step
SYNTHETIC_ARGV = ("--synthetic", "--epochs", "12", "--batch-size", "64", "--subset-size",
                  "2000", "--device-aug", "--num-workers", "4")
SYNTHETIC_MIN_TOP1 = 0.70  # JAX on its chip: 0.8025; chance ~0.09
REMAT_BATCH = 256


def _l2(t) -> float:
    return float(t.double().norm())


def compare_bf16_steps(torch, runs, lr: float) -> dict:
    """``runs`` maps cpu32, cpu16, card32, card16 to (model, metrics) of one
    train step from the same weights and batch; returns the distances and
    ``failures`` against the bounds above."""
    failures = []
    loss = {k: float(m["loss"]) for k, (_, m) in runs.items()}
    loss_noise = abs(loss["cpu16"] - loss["cpu32"])
    loss_err = abs(loss["card16"] - loss["cpu16"])
    if loss_err > 2 * loss_noise + 2 ** -8 * abs(loss["cpu16"]):
        failures.append(f"loss off by {loss_err:.3e} (the CPU's noise {loss_noise:.3e})")

    def named(model, kind):
        items = model.named_parameters() if kind == "grad" else model.named_buffers()
        return {k: (v.grad if kind == "grad" else v).detach().cpu().double()
                for k, v in items
                if kind == "grad" or k.endswith(("running_mean", "running_var"))}

    def median_rel(a, b):
        return float(np.median([_l2(a[k] - b[k]) / _l2(b[k]) for k in b if _l2(b[k]) > 0]))

    out = dict(loss={k: v for k, v in loss.items()}, loss_err=loss_err, loss_noise=loss_noise)
    for kind in ("grad", "bn"):
        t = {k: named(m, kind) for k, (m, _) in runs.items()}
        ref = t["cpu32"]
        m_cpu = median_rel(t["cpu16"], ref)
        m_card = median_rel(t["card16"], t["card32"])
        top = max(float(v.abs().max()) for v in ref.values())
        shares = []
        for name, r in ref.items():
            err = _l2(t["card16"][name] - t["cpu16"][name])
            noise = _l2(t["cpu16"][name] - r)
            scale = float(r.abs().max()) if kind == "grad" else max(1.0, float(r.abs().max()))
            bound = (2 * noise + m_cpu * _l2(r) + STEP_REL_FLOOR * scale * math.sqrt(r.numel())
                     + (STEP_GLOBAL_FLOOR * top * math.sqrt(r.numel()) if kind == "grad" else 0))
            shares.append((err / bound, name, err, noise))
        shares.sort(reverse=True)
        past = [x for x in shares if x[0] > 1]
        failures += [f"{kind} {n}: err {e:.3e} > {BF16_STEP_CAP}x the bound (CPU noise {z:.3e})"
                     for f, n, e, z in past if f > BF16_STEP_CAP]
        if len(past) > BF16_STEP_ALLOWED[kind]:
            failures.append(f"{len(past)} {kind} tensors past the bound (allowed "
                            f"{BF16_STEP_ALLOWED[kind]})")
        if m_card > 2 * m_cpu:
            failures.append(f"{kind}: the card's own bf16 noise {m_card:.3e} > 2x the CPU's "
                            f"{m_cpu:.3e}")
        out[kind] = dict(cpu_noise=m_cpu, card_noise=m_card, n_past_bound=len(past), worst=[
            dict(name=n, err=e, cpu_noise=z, share_of_bound=f) for f, n, e, z in shares[:4]])
    card_params = dict(runs["card16"][0].named_parameters())
    param_err = max(float((card_params[n].detach().cpu() - p.detach().cpu()).abs().max())
                    for n, p in runs["cpu16"][0].named_parameters())
    if param_err > 2 * lr + 1e-6:
        failures.append(f"parameters off by {param_err:.3e} > 2·lr")
    dtypes = {p.dtype for m, _ in runs.values() for p in m.parameters()}
    if dtypes != {torch.float32}:
        failures.append(f"parameters in {dtypes}")
    out.update(param_err=param_err, failures=failures)
    return out


def bf16_step_card_vs_cpu(torch, cfg, device, lr: float = 1e-4,
                          batch: int = BF16_STEP_BATCH) -> dict:
    """(a) One bf16 step on the card against the same step on the CPU, each
    beside its f32 step, from the same weights and synthetic batch."""
    import dataclasses

    cfg = dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)
    arrays = synthetic_batch(cfg, batch, seed=1)
    runs = {}
    for name, where, dtype in (("cpu32", "cpu", torch.float32), ("cpu16", "cpu", torch.bfloat16),
                               ("card32", device, torch.float32),
                               ("card16", device, torch.bfloat16)):
        t0 = time.perf_counter()
        runs[name] = one_train_step(torch, cfg, where, arrays, lr, dtype=dtype)
        log(f"train step, {name}: loss {float(runs[name][1]['loss']):.7f}, "
            f"{time.perf_counter() - t0:.2f} s")
    r = compare_bf16_steps(torch, runs, lr)
    for kind in ("grad", "bn"):
        log(f"bf16 card vs CPU, {kind}: own median relative bf16 noise CPU "
            f"{r[kind]['cpu_noise']:.3e}, card {r[kind]['card_noise']:.3e}; "
            f"{r[kind]['n_past_bound']} tensors past the bound (allowed "
            f"{BF16_STEP_ALLOWED[kind]}, each within {BF16_STEP_CAP}x); nearest: " + "; ".join(
                f"{w['name']} err {w['err']:.3e} CPU noise {w['cpu_noise']:.3e} "
                f"({100 * w['share_of_bound']:.0f}%)" for w in r[kind]["worst"]))
    log(f"bf16 card vs CPU, one step at B={batch} (lr {lr}): losses {r['loss']}, err "
        f"{r['loss_err']:.3e} (CPU noise {r['loss_noise']:.3e}); params max err "
        f"{r['param_err']:.3e} (tol 2·lr)")
    require(not r["failures"], "bf16 train step card vs CPU: " + "; ".join(r["failures"][:5]))
    del r["failures"]
    r.update(lr=lr, batch=batch)
    return r


def synthetic_run(torch, tmp: str) -> tuple:
    """(b) ``python -m vqa_tpu_torch.training.train`` with SYNTHETIC_ARGV
    (bf16, the default on the card), launches counted per epoch, then
    ``evaluate --synthetic --bf16`` on its best_model. Returns (summary,
    the bf16 forms' launches over every validation forward)."""
    from vqa_tpu_torch.training import checkpoint as ckpt_lib

    trainer, cli = drive_train_cli(torch, tmp, argv=SYNTHETIC_ARGV, form="_bf16")
    require(trainer.model.dtype == torch.bfloat16,
            f"the train CLI on the card trained in {trainer.model.dtype}")
    epochs = cli["epochs"]
    best = max(e["val_top1"] for e in epochs)
    best_epoch = ckpt_lib.load_checkpoint_meta(tmp, "best_model")["epoch"]
    log(f"synthetic run: val top-1 per epoch {[round(e['val_top1'], 4) for e in epochs]}, "
        f"top-5 {[round(e['val_top5'], 4) for e in epochs]}, seconds per epoch "
        f"{[round(e['train_s'] + e['val_s'], 1) for e in epochs]}; best {best:.4f} at epoch "
        f"{best_epoch} (JAX on its chip: 0.8025)")
    require(best >= SYNTHETIC_MIN_TOP1, f"synthetic run: best val top-1 {best} < "
            f"{SYNTHETIC_MIN_TOP1}")
    launches = {name: sum(e["val_launches"][name] for e in epochs)
                for name in epochs[0]["val_launches"]}
    n = len(trainer.val_loader.dataset)
    del trainer
    # the evaluator runs the same bf16 forms on the same split, in batches of
    # 64; one answer either way is allowed
    ev = drive_evaluate(torch, tmp, best, forms=("_bf16",), top1_tol=1.0 / n)
    return dict(cli, best_val_top1=best, best_epoch=best_epoch, evaluate=ev), launches


REMAT_TOL = 1e-6  # stages/full against none: loss, clipped gradients, BN statistics


def remat_check(torch, cfg, device, batch: int = REMAT_BATCH, lr: float = 1e-4) -> dict:
    """(d) none, stages and full from the same weights, batch and dropout
    seed, bf16. The first step runs with deterministic cuDNN algorithms,
    so that what differs is the recomputation alone: its loss equal to
    none's, its clipped gradients (each parameter's ``.grad`` after the
    step) and BN statistics within REMAT_TOL, BN counted once; peak memory of
    the first step and ms per step over 6 more (cuDNN as the trainer runs
    it)."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig

    rng = np.random.default_rng(batch + 1)
    size, L = cfg.image_size, cfg.max_question_length
    args = [torch.from_numpy(a).to(device) for a in (
        rng.standard_normal((batch, size, size, 3)).astype(np.float32),
        rng.integers(4, cfg.vocab_size, (batch, L)).astype(np.int32),
        np.ones((batch, L), np.int32),
        rng.integers(0, cfg.num_answers, batch).astype(np.int32))]
    out, first = {}, {}
    for mode in ("none", "stages", "full"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        model = create_vqa_model(config=cfg, device=device, seed=14, dtype=torch.bfloat16)
        state = TrainState.create(
            model, TrainingConfig(learning_rate=lr, warmup_epochs=0, num_epochs=3), 10)
        step = make_train_step(model, remat=mode)
        torch.manual_seed(21)  # the same dropout masks for the three
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
            loss = float(step(state, *args)["loss"])
        peak = torch.cuda.max_memory_allocated(device)
        first[mode] = (loss, {k: p.grad.detach().float().cpu()
                              for k, p in model.named_parameters()},
                       {k: b.detach().float().cpu() for k, b in model.named_buffers()
                        if k.endswith(("running_mean", "running_var"))})
        tracked = int(model.image_encoder.stem[1].num_batches_tracked)
        step(state, *args)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(6):
            step(state, *args)
        end.record()
        end.synchronize()
        out[mode] = dict(first_loss=loss, peak_memory_bytes=peak,
                         step_ms=start.elapsed_time(end) / 6, bn_batches_tracked=tracked)
        require(tracked == 1, f"remat {mode}: BN counted {tracked} updates in one step")
        del model, state, step
    _, grads0, bn0 = first["none"]
    for mode in ("stages", "full"):
        loss, grads, bn = first[mode]
        errs = dict(loss=abs(loss - first["none"][0]),
                    grad=max(float((grads[k] - g).abs().max()) for k, g in grads0.items()),
                    bn=max(float((bn[k] - b).abs().max()) for k, b in bn0.items()))
        equal = (loss == first["none"][0] and all(torch.equal(grads[k], g) for k, g in grads0.items())
                 and all(torch.equal(bn[k], b) for k, b in bn0.items()))
        out[mode].update({f"{k}_err_vs_none": v for k, v in errs.items()}, bit_equal=equal)
        require(loss == first["none"][0], f"remat {mode}: first loss {loss} != none's")
        for k, v in errs.items():
            require(v <= REMAT_TOL, f"remat {mode}: {k} off by {v:.3e} from none's")
    for mode, r in out.items():
        log(f"remat {mode} at B={batch}, bf16: {r['step_ms']:.3f} ms per step, peak "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, first loss {r['first_loss']:.7f}"
            + (f" (vs none: loss {r['loss_err_vs_none']:.3e}, clipped gradients "
               f"{r['grad_err_vs_none']:.3e}, BN {r['bn_err_vs_none']:.3e}, tol {REMAT_TOL}; "
               f"bit-equal {r['bit_equal']})" if mode != "none" else ""))
    return out


def debug_nans_check(torch, cfg, device) -> str:
    """(e) A batch with one NaN pixel stops a --debug-nans step."""
    import warnings

    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig

    arrays = synthetic_batch(cfg, BF16_STEP_BATCH, seed=3)
    arrays[0][2, cfg.image_size // 2, cfg.image_size // 3, 1] = np.nan
    model = create_vqa_model(config=cfg, device=device, seed=15, dtype=torch.bfloat16)
    state = TrainState.create(model, TrainingConfig(warmup_epochs=0), 10)
    step = make_train_step(model, debug_nans=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's traceback of the forward
            step(state, *(torch.from_numpy(a).to(device) for a in arrays))
    except FloatingPointError as e:
        log(f"--debug-nans: a batch with one NaN pixel stopped the step: {str(e)[:160]}")
        require(state.step == 0, "the NaN step updated the parameters")
        return str(e)[:400]
    raise SystemExit("chip_smoke: FAILED: a NaN batch passed a --debug-nans step")


def s2d_check(torch, cfg, device, lr: float = 1e-4, batch: int = 32) -> dict:
    """(f) One f32 step (TF32 off) with ``stem_s2d`` against the same step
    without it, on the card: the loss within 1e-5, and phase 10 (a)'s
    bounds for the step as the trainer runs it (``compare_train_steps``'
    ``cudnn_failures``: top-k counts, BN statistics per tensor, the
    gradients as a whole within 10x the noise, parameters within 2·lr).
    The noise is that of the plain step on the batch in another order and
    with cuDNN off."""
    import dataclasses

    cfg = dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)
    arrays = synthetic_batch(cfg, batch, seed=4)
    perm = np.random.default_rng(1).permutation(batch)
    runs = {}
    for name, data, cudnn, kw in (("plain", arrays, True, {}),
                                  ("plain_permuted", [a[perm] for a in arrays], True, {}),
                                  ("plain_cudnn_off", arrays, False, {}),
                                  ("s2d", arrays, True, dict(stem_s2d=True))):
        with torch.backends.cudnn.flags(enabled=cudnn, deterministic=False, benchmark=False,
                                        allow_tf32=False):
            runs[name] = one_train_step(torch, cfg, device, data, lr, **kw)
    r = compare_train_steps(torch, runs["plain"], [runs["plain_permuted"],
                                                   runs["plain_cudnn_off"]], runs["s2d"], lr)
    for kind in ("grad", "bn"):
        log(f"--stem-s2d vs plain, {kind}: relative L2 error {r[kind]['rel_l2_err']:.3e} (the "
            f"plain step's own noise {r[kind]['rel_l2_noise']:.3e}), max per-tensor error "
            f"{r[kind]['max_rel_err']:.3e} of the tensor's max")
    log(f"--stem-s2d at B={batch}, f32: loss err {r['loss_err']:.3e} (tol {STEP_LOSS_TOL}; "
        f"noise {r['loss_noise']:.3e}), params max err {r['param_err']:.3e} (tol 2·lr)")
    require(r["loss_err"] <= 1e-5, f"s2d step: loss off by {r['loss_err']:.3e}")
    require(not r["cudnn_failures"], "s2d step vs plain: " + "; ".join(r["cudnn_failures"][:5]))
    del r["failures"], r["cudnn_failures"]
    r["batch"] = batch
    return r


def drive_bf16_training(torch, tmp: str, f32_timing: dict) -> tuple:
    """Phase 12, bf16 training at full width (``ModelConfig()``, 224 px):
    (a) card vs CPU, (b) the 12-epoch synthetic run and its evaluation,
    (c) timing beside phase 10 (f)'s f32, (d) remat, (e) --debug-nans,
    (f) --stem-s2d. Returns (summary, the bf16 forms' launches over the
    run's validation forwards)."""
    from vqa_tpu_torch.utils.config import ModelConfig

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = ModelConfig()
    t0 = time.perf_counter()
    out, seconds = {}, {}

    def phase(name, fn):
        t = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t
        log(f"phase 12 ({name}): {seconds[name]:.1f} s")
        return result

    out["card_vs_cpu"] = phase("a", lambda: bf16_step_card_vs_cpu(torch, cfg, device))
    out["synthetic"], launches = phase("b", lambda: synthetic_run(torch, tmp))
    out["timing"] = phase("c", lambda: {str(b): train_timing(torch, cfg, device, b,
                                                              dtype=torch.bfloat16)
                                        for b in TRAIN_BATCH_SIZES})
    for b in TRAIN_BATCH_SIZES:
        bf, f = out["timing"][str(b)], f32_timing[str(b)]
        log(f"train step at B={b}: bf16 {bf['step_ms']:.3f} ms ({bf['pairs_per_s']:.1f} "
            f"pairs/s, busy {100 * bf['device_busy_share']:.1f}%, peak "
            f"{bf['peak_memory_bytes'] / 2**30:.2f} GiB), f32 {f['step_ms']:.3f} ms "
            f"({f['pairs_per_s']:.1f} pairs/s, busy {100 * f['device_busy_share']:.1f}%, peak "
            f"{f['peak_memory_bytes'] / 2**30:.2f} GiB) in this call")
    out["remat"] = phase("d", lambda: remat_check(torch, cfg, device))
    out["debug_nans"] = phase("e", lambda: debug_nans_check(torch, cfg, device))
    out["stem_s2d"] = phase("f", lambda: s2d_check(torch, cfg, device))
    out["phase_seconds"] = seconds
    out["seconds"] = time.perf_counter() - t0
    log(f"bf16 training phase: {out['seconds']:.1f} s")
    return out, launches


# ---- phase 11: bf16 serving and evaluation ---------------------------------

# A bf16 attention-map row is 49 probabilities each rounded to bf16 (relative
# error at most 2^-9, so the row sums to 1 within 2^-9), then averaged over
# the two layers and the eight heads, each mean rounded to bf16 again.
BF16_MAP_TOL = 3 * 2.0 ** -9


# The bf16 stem's output is relu(conv * scale + bias), and where the affine
# nearly cancels the conv the value is ~1e-6: there the f32 sum's own error
# (each of the kernel and cuDNN's f32 conv within ~1e-6 of an f64
# reference on the H100) is more than a bf16 ulp of the value. So an
# element of the stem may also differ by the stem's f32 tolerance, 1e-5.
STEM_BF16_ATOL = 1e-5


def bf16_compare(torch, got, want, atol: float = 0.0) -> dict:
    """A bf16 output against its plain version, compared as f32, in units
    of the bf16 spacing at the larger magnitude of the two: the largest
    error, the elements beyond one ulp (and the largest |value| and error
    among them), and whether every element is within one ulp + ``atol``."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 7)
    d = (g - w).abs()
    beyond = d > ulp
    n = int(beyond.sum())
    return dict(ulps=float((d / ulp).max()), beyond=n,
                beyond_max_value=float(mag[beyond].max()) if n else 0.0,
                beyond_max_err=float(d[beyond].max()) if n else 0.0,
                ok=bool((d <= ulp + atol).all()))


def bound16_ms(nbytes: float, flops: float):
    """The bound of a bf16 form: its bytes over 3.35 TB/s or its operations
    over the bf16 tensor-core peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels_bf16(torch, engine, rng):
    """(a) Each bf16 form against its bf16 plain version on the card at the
    main path's bucket-32 shapes (within one bf16 ulp per element), with
    times and bf16 bounds per forward; the stem also at buckets 1 and 8,
    with its launch plan (the library's shared memory held to stem_plan's)
    and cuDNN's bf16 conv alone as a yardstick."""
    import torch.nn.functional as F

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.ops._build import load_library
    from vqa_tpu_torch.ops.cross_attention_kernel import bf16_geometry
    from vqa_tpu_torch.ops.se_kernel import (SEPlan, _smem_bytes, max_active_clusters,
                                             se_plan)
    from vqa_tpu_torch.ops.stem_kernel import stem_plan

    dev, model, bf16 = engine.device, engine.model, torch.bfloat16
    results = {}

    def check(name, got, want, atol=0.0):
        torch.cuda.synchronize()
        c, err = bf16_compare(torch, got, want, atol), max_err(got.float(), want.float())
        log(f"{name}: max abs err {err:.3e}, {c['ulps']:.3f} bf16 ulp; {c['beyond']} "
            f"elements beyond 1 ulp (largest |value| {c['beyond_max_value']:.3e}, error "
            f"{c['beyond_max_err']:.3e}; tol 1 ulp + {atol:.0e})")
        require(got.dtype == bf16 and c["ok"], f"{name} disagrees with its plain version")
        return err

    # ---- stem, at buckets 1, 8 and 32 ---------------------------------
    size = model.config.image_size
    w = model.image_encoder.stem[0].compute("weight")
    cout = w.shape[0]
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)).to(dev)
    ch = (size - 1) // 2 + 1
    buckets = {}
    for b in STEM_BUCKETS:
        pixels = torch.from_numpy(
            rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)).to(dev)
        x = device_normalize(pixels).to(bf16).contiguous()
        plan = stem_plan(b, size, size, cout, 2, x.data_ptr() % 16 == 0)
        lib_smem = load_library().vqa_stem_bf16_smem_bytes()
        log(f"stem bf16 plan at B={b}: tiles of {plan.tile[0]}x{plan.tile[1]} pool outputs, "
            f"{plan.tiles} tiles, {plan.blocks_per_sm} blocks per SM (grid {plan.grid}), "
            f"{plan.smem_bytes} bytes of shared memory per block (the library's layout: "
            f"{lib_smem}), the patch by "
            f"{'TMA' if plan.tma else 'plain loads'}")
        require(lib_smem == plan.smem_bytes,
                f"stem_plan's {plan.smem_bytes} bytes of shared memory against the library's "
                f"{lib_smem}")
        require(plan.tma, f"the engine's stem at B={b} does not take the TMA route")
        got = ops.fused_stem(x, w, scale, bias)
        err = check(f"stem bf16 {tuple(x.shape)} -> {tuple(got.shape)}", got,
                    ops.plain_stem(x, w, scale, bias), STEM_BF16_ATOL)
        bnd, by = bound16_ms(2 * (x.numel() + w.numel() + got.numel()) + 8 * cout,
                             2 * b * ch * ch * cout * 147)
        (k_ms, k_call), (p_ms, p_call) = (
            time_ms(torch, lambda: ops.fused_stem(x, w, scale, bias), 20),
            time_ms(torch, lambda: ops.plain_stem(x, w, scale, bias), 20))
        # cuDNN's bf16 conv alone on the same NHWC memory (channels_last): a
        # yardstick for the conv, not the same function (no BN, ReLU or pool)
        xc = x.permute(0, 3, 1, 2)
        conv_ms, _ = time_ms(torch, lambda: F.conv2d(xc, w, stride=2, padding=3), 20)
        log(f"stem bf16 at B={b}: kernel {k_ms:.4f} ms on the device ({k_call:.4f} ms per "
            f"call), plain {p_ms:.4f} ms, bound {bnd:.4f} ms ({by}); cuDNN bf16 conv only "
            f"(not the same function) {conv_ms:.4f} ms")
        buckets[b] = dict(max_abs_err=err, ms=k_ms, call_ms=k_call, plain_ms=p_ms,
                          plain_call_ms=p_call, bound_ms=bnd, bound_by=by,
                          cudnn_conv_only_ms=conv_ms)
    results["stem_bf16"] = dict(
        route="cuda", source="vqa_tpu_torch/csrc/stem.cu",
        replaces="vqa_tpu/ops/stem_kernel.py:141", **buckets[BUCKET], library_ms=None,
        buckets=buckets)
    results["stem_bf16"]["max_abs_err"] = max(r["max_abs_err"] for r in buckets.values())

    # ---- SE, at the four stage shapes ---------------------------------
    se = dict(route="cuda", source="vqa_tpu_torch/csrc/se.cu",
              replaces="vqa_tpu/ops/se_kernel.py:50", max_abs_err=0.0, ms=0.0,
              plain_ms=0.0, call_ms=0.0, plain_call_ms=0.0, library_ms=None, stages=[])
    se_bytes = se_flops = 0
    for i, (hw, c) in enumerate(SE_STAGES, start=1):
        mod = getattr(model.image_encoder, f"stage{i}").attention.se
        w1, w2 = mod.fc1.compute("weight"), mod.fc2.compute("weight")
        r = w1.shape[0]
        xs = torch.relu(torch.from_numpy(
            rng.standard_normal((BUCKET, hw, hw, c)).astype(np.float32)).to(dev)).to(bf16)
        plan = se_plan(BUCKET, hw * hw, c, r, 2)
        active = max_active_clusters(plan, hw * hw, c, r, 8, 2)
        log(f"se bf16 stage{i} plan: cluster {plan.cluster}, "
            f"{'resident' if plan.resident(hw * hw) else f'{plan.keep_rows} rows kept'}, split "
            f"by {'rows' if plan.rows else 'channels'}, {plan.smem_bytes} bytes of shared "
            f"memory per block, {active} clusters resident at once for {BUCKET} images")
        se["max_abs_err"] = max(se["max_abs_err"], check(
            f"se bf16 stage{i} {tuple(xs.shape)} r={r}", ops.fused_se(xs, w1, w2),
            ops.plain_se(xs, w1, w2)))
        k_ms, k_call = time_ms(torch, lambda: ops.fused_se(xs, w1, w2), 50)
        p_ms, p_call = time_ms(torch, lambda: ops.plain_se(xs, w1, w2), 50)
        nbytes = 2 * (2 * xs.numel() + w1.numel() + w2.numel())
        flops = 2 * xs.numel() + 4 * BUCKET * c * r + 4 * BUCKET * c
        stage_bound, stage_by = bound16_ms(nbytes, flops)
        log(f"se bf16 stage{i}: kernel {k_ms:.4f} ms on the device ({k_call:.4f} ms per call), "
            f"plain {p_ms:.4f} ms, bound {stage_bound:.4f} ms ({stage_by}; "
            f"{100 * stage_bound / k_ms:.0f}% of it)")
        se["stages"].append(dict(stage=i, shape=list(xs.shape), cluster=plan.cluster,
                                 rows=plan.rows, keep_rows=plan.keep_rows, ms=k_ms,
                                 call_ms=k_call, plain_ms=p_ms, bound_ms=stage_bound,
                                 bound_by=stage_by))
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("call_ms", k_call),
                       ("plain_call_ms", p_call)):
            se[key] += v
        se_bytes += nbytes
        se_flops += flops
    se["bound_ms"], se["bound_by"] = bound16_ms(se_bytes, se_flops)
    # the streaming mode: stage 1 at 448 px, too large for a resident cluster
    # per image at B = 32 (a block keeps part of its rows and reads the rest
    # twice), and a plan that keeps no row at all, through the launcher
    mod = model.image_encoder.stage1.attention.se
    w1, w2 = mod.fc1.compute("weight"), mod.fc2.compute("weight")
    r = w1.shape[0]
    xs = torch.relu(torch.from_numpy(
        rng.standard_normal((BUCKET, 112, 112, 64)).astype(np.float32)).to(dev)).to(bf16)
    plan = se_plan(BUCKET, 112 * 112, 64, r, 2)
    require(not plan.resident(112 * 112), f"se bf16 at 448 px is resident: {plan}")
    log(f"se bf16 at 448 px plan: cluster {plan.cluster}, {plan.keep_rows} of "
        f"{plan.block_rows(112 * 112)} rows kept, split by {'rows' if plan.rows else 'channels'}")
    want = ops.plain_se(xs, w1, w2)
    se["max_abs_err"] = max(se["max_abs_err"], check(
        f"se bf16 {tuple(xs.shape)} r={r} (streaming part of the rows)",
        ops.fused_se(xs, w1, w2), want))
    streamed = SEPlan(plan.cluster, plan.rows, 0,
                      _smem_bytes(64, r, plan.cluster, 0, plan.rows, 2))
    out = torch.empty_like(xs)
    rc = load_library().vqa_se_bf16(
        xs.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), BUCKET, 112 * 112, 64, r,
        streamed.cluster, 0, int(streamed.rows), streamed.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"se bf16 refused the streaming plan {streamed}: CUDA error {rc}")
    se["max_abs_err"] = max(se["max_abs_err"], check(
        f"se bf16 {tuple(xs.shape)} r={r} (every row streamed)", out, want))
    results["se_bf16"] = se

    # ---- cross-attention, both fusion layers -------------------------
    cfg = model.config
    heads, dh = cfg.num_attention_heads, cfg.embed_dim // cfg.num_attention_heads
    lq, lkv, nlayers = cfg.max_question_length, cfg.feature_spatial_size ** 2, cfg.num_cross_layers
    q, k, v = (torch.from_numpy(rng.standard_normal((BUCKET, n, heads, dh)).astype(np.float32))
               .to(dev).to(bf16).transpose(1, 2) for n in (lq, lkv, lkv))
    sc = math.sqrt(dh)
    geo = bf16_geometry(BUCKET * heads, lq, lkv, dh)
    lib_geo = (ctypes.c_int * 3)()
    require(load_library().vqa_cross_attention_bf16_geometry(
        BUCKET, heads, lq, lkv, dh, lib_geo) == 0, "the bf16 cross-attention geometry query failed")
    log(f"cross_attention bf16 geometry: {geo.blocks} blocks (one slice each) of {geo.warps} "
        f"warps, {geo.smem_bytes} bytes of shared memory (the library's: {list(lib_geo)})")
    require(list(lib_geo) == [geo.warps, geo.threads, geo.smem_bytes],
            "bf16_geometry disagrees with the library's launch geometry")
    (ctx, wts), (pctx, pw) = (ops.fused_cross_attention(q, k, v, sc),
                              ops.plain_cross_attention(q, k, v, sc))
    err = max(check("cross_attention bf16 context", ctx, pctx),
              check("cross_attention bf16 weights", wts, pw))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + ctx.numel() + wts.numel())
    flops = 4 * BUCKET * heads * lq * lkv * dh + 5 * wts.numel()
    bnd, by = bound16_ms(nlayers * nbytes, nlayers * flops)
    k_ms, k_call = time_ms(torch, lambda: ops.fused_cross_attention(q, k, v, sc), 200)
    p_ms, p_call = time_ms(torch, lambda: ops.plain_cross_attention(q, k, v, sc), 200)
    lib_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 200)
    results["cross_attention_bf16"] = dict(
        route="cuda", source="vqa_tpu_torch/csrc/cross_attention.cu",
        replaces="vqa_tpu/ops/cross_attention_kernel.py:73", max_abs_err=err,
        ms=nlayers * k_ms, plain_ms=nlayers * p_ms, call_ms=nlayers * k_call,
        plain_call_ms=nlayers * p_call, bound_ms=bnd, bound_by=by,
        library_ms=nlayers * lib_ms)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name} per forward: kernel {r['ms']:.4f} ms on the device "
            f"({r['call_ms']:.4f} ms per call), plain {r['plain_ms']:.4f} ms "
            f"({r['plain_call_ms']:.4f} ms per call), library {lib} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def bucket_spread(engine, rng, n: int = 8) -> dict:
    """The same request's probabilities at buckets 1, 4, 16 and 32 (the
    request first, the rest of the batch other requests), against bucket
    1: the most any probability moves with the batch size. In bf16 this is
    not 0 where cuDNN takes another algorithm for another batch size."""
    size = engine.model.config.image_size
    pixels = rng.integers(0, 256, (n + BUCKET, size, size, 3), dtype=np.uint8)
    qs = [HTTP_QUESTIONS[i % 5] for i in range(n + BUCKET)]
    alone = np.stack([engine.predict_probs_from_pixels(pixels[i:i + 1], qs[i:i + 1])[0]
                      for i in range(n)])
    spread = {}
    for bucket in engine.cfg.batch_buckets[1:]:
        rows = []
        for i in range(n):
            others = [n + j for j in range(bucket - 1)]
            rows.append(engine.predict_probs_from_pixels(
                pixels[[i] + others], [qs[i]] + [qs[j] for j in others])[0])
        spread[bucket] = float(np.abs(np.stack(rows) - alone).max())
    log(f"{engine.dtype} engine: one request's probabilities at buckets "
        f"{tuple(spread)} against bucket 1, max over {n} requests: "
        + ", ".join(f"{b}: {v:.3e}" for b, v in spread.items()))
    return spread


def compare_whole_model_bf16(torch, engine16, engine32, rng) -> dict:
    """(b) Whole-model bf16 logits through the kernels against the same
    engine's bf16 plain versions on the card: no further apart than the
    plain bf16 logits are from the f32 engine's (the kernels add no error
    beyond bf16's own); the argmax agrees with f32 on every row whose f32
    top-2 margin exceeds twice that bf16 noise."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel

    size = engine16.model.config.image_size
    pixels = torch.from_numpy(
        rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)).to(engine16.device)
    ids, mask = engine16.tokenizer.encode_batch_np(
        [HTTP_QUESTIONS[i % 5] for i in range(BUCKET)])
    ids = torch.from_numpy(ids).long().to(engine16.device)
    mask = torch.from_numpy(mask).to(engine16.device)
    with torch.inference_mode():
        kernel16, _ = engine16.model(device_normalize(pixels), ids, mask)
        f32, _ = engine32.model(device_normalize(pixels), ids, mask)
        before = ops.launch_counts()
        with mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
                mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
                mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                                  cross_attention_kernel.plain_cross_attention):
            plain16, _ = engine16.model(device_normalize(pixels), ids, mask)
        torch.cuda.synchronize()
    require(ops.launch_counts() == before, "the plain run launched a kernel")
    require(bool(torch.isfinite(kernel16).all()), "non-finite bf16 logits")
    noise, err = max_err(plain16, f32), max_err(kernel16, plain16)
    margin = f32.topk(2, dim=-1).values
    clear = (margin[:, 0] - margin[:, 1]) > 2 * noise
    agree = bool((kernel16.argmax(-1) == f32.argmax(-1))[clear].all())
    log(f"whole-model bf16 logits [{BUCKET}, {kernel16.shape[1]}]: kernels vs plain "
        f"{err:.3e}, plain bf16 vs f32 {noise:.3e} (bf16's own noise), kernels vs f32 "
        f"{max_err(kernel16, f32):.3e}; argmax equal to f32 on {int(clear.sum())} rows "
        f"with a margin over {2 * noise:.3e}: {agree}")
    require(err <= noise, "the bf16 kernels add error beyond bf16's own")
    require(agree, "bf16 argmax differs from f32 on a row with a clear margin")
    return dict(kernels_vs_plain=err, plain_vs_f32=noise, rows_compared=int(clear.sum()))


def drive_http_bf16(torch, engine, rng, tol: float) -> dict:
    """(d) The HTTP server on the default (bf16) engine: 8 clients x 4
    /predict, one decoded image each; no failed request, every answer
    within ``tol`` of the engine's answer to the same request alone, and
    the bf16 forms launched 1, 4 and 2 times per forward."""
    import http.client

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.serving.server import VQAServer

    n_clients, per_client = 8, 4
    reqs = [(image_bytes(rng, int(h), int(w)), HTTP_QUESTIONS[i % 5])
            for i, (h, w) in enumerate(rng.integers(64, 400, (n_clients * per_client, 2)))]
    want = [engine.predict_batch_raw([img], [q])[0] for img, q in reqs]
    server = VQAServer(engine=engine)  # warms every bucket, as the CLI does
    thread = threading.Thread(target=server.serve, args=("127.0.0.1", 0), daemon=True)
    thread.start()
    while server._httpd is None:
        time.sleep(0.01)
    port = server._httpd.server_address[1]
    ops.reset_launch_counts()
    results = [None] * len(reqs)

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        for k in range(c * per_client, (c + 1) * per_client):
            img, q = reqs[k]
            body, ctype = multipart({"question": q, "top_k": "5"}, [("image", "x.png", img)])
            status, out = http_request(port, "POST", "/predict", body,
                                       {"Content-Type": ctype}, conn)
            results[k] = (status, json.loads(out))
        conn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    require(not any(t.is_alive() for t in threads), "a bf16 /predict client hung")
    same_top = 0
    for k, (status, out) in enumerate(results):
        require(status == 200, f"bf16 /predict {k}: HTTP {status}")
        same_top += check_answer(out, want[k], f"bf16 /predict {k}", tol)
    forwards = server.batcher.total_batches
    launches = ops.launch_counts()
    server.drain(timeout=30)
    thread.join(timeout=10)
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[name + "_bf16"] == per_forward * forwards and launches[name] == 0,
                f"bf16 HTTP: {name} launches {launches} in {forwards} forwards")
    log(f"bf16 /predict: {len(reqs)} requests from {n_clients} clients in {forwards} batches, "
        f"every answer within {tol:.3e} of the request alone, top answer identical in "
        f"{same_top}; launches {launches}")
    return dict(requests=len(reqs), batches=forwards, tol=tol, top_answer_identical=same_top,
                launches=launches)


def drive_evaluate(torch, tmp: str, val_top1: float, extra=(), forms=("", "_bf16"),
                   top1_tol: float = 0.0) -> dict:
    """(e) ``python -m vqa_tpu_torch.training.evaluate --synthetic`` on the
    training phase's checkpoint, in this process, in f32 and ``--bf16``
    (``forms``): the first form's top-1 equal to the trainer's own
    validation of the same weights on the same split (within
    ``top1_tol``); each evaluation forward launches the f32 forms (f32) or
    the bf16 forms (--bf16) 1, 4 and 2 times; the artifacts written."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.training import evaluate

    out = {}
    for form in forms:
        flags = ("--bf16",) if form else ()
        out_dir = os.path.join(tmp, "eval" + form)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate.main(["--checkpoint-dir", tmp, "--synthetic", "--output-dir", out_dir,
                             *flags, *extra])
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        forwards = -(-res["num_samples"] // 64)  # the evaluator's --batch-size
        other = "_bf16" if not form else ""
        for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
            require(launches[name + form] == per_forward * forwards
                    and launches[name + other] == 0,
                    f"evaluate{' '.join(flags)}: launches {launches} in {forwards} forwards")
        for f in ("evaluation_results.json", "evaluation_report.txt"):
            require(os.path.exists(os.path.join(out_dir, f)), f"evaluate: no {f}")
        out["f32" if not form else "bf16"] = dict(
            seconds=wall, samples=res["num_samples"], forwards=forwards,
            top1=res["top1_accuracy"], top5=res["top5_accuracy"], loss=res["loss"],
            launches=launches)
        log(f"evaluate --synthetic {' '.join(flags)}: {res['num_samples']} samples in "
            f"{forwards} forwards, {wall:.1f} s, top-1 {res['top1_accuracy']:.4f}, top-5 "
            f"{res['top5_accuracy']:.4f}, loss {res['loss']:.6f}; launches {launches}")
    first = out["bf16" if forms[0] else "f32"]
    require(abs(first["top1"] - val_top1) <= top1_tol,
            f"evaluator top-1 {first['top1']} vs the trainer's validation {val_top1}")
    return out


def drive_bf16(torch, engine32, tput32, tmp: str, val_top1: float, rng, seed: int,
               with_profile: bool = False) -> tuple:
    """Phase 11, bf16 serving and evaluation at full width: (a) the bf16
    forms against their plain versions, (b) the default engine (bf16 on the
    card) through the main path's entry points with launch counts, and its
    logits against its plain versions and f32, (c) pairs/s and latency,
    (d) HTTP, (e) the evaluator CLI. Returns (bf16 kernel results, summary)."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import ModelConfig

    t0 = time.perf_counter()
    engine = VQAInference(model_config=ModelConfig(), device="cuda", seed=seed).load()
    require(engine.dtype == torch.bfloat16 and engine.model.dtype == torch.bfloat16,
            f"the default engine on the card computes in {engine.dtype}")
    with torch.no_grad():
        kernels = check_kernels_bf16(torch, engine, rng)
    engine.warmup()
    spread = bucket_spread(engine, rng)
    # the tolerance of every bf16 answer against the same request alone:
    # twice the largest spread measured over buckets 1-32, and no less than
    # the f32 engine's 1e-4
    tol = max(1e-4, 2 * max(spread.values()))
    ops.reset_launch_counts()
    forwards = drive_main_path(engine, rng, alone_tol=tol, map_tol=BF16_MAP_TOL)
    launches = ops.launch_counts()
    log(f"bf16 main path: {forwards} forwards, kernel launches {launches}")
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[name + "_bf16"] == per_forward * forwards and launches[name] == 0,
                f"bf16 main path: {name} launches {launches} in {forwards} forwards")
        kernels[name + "_bf16"]["launches"] = launches[name + "_bf16"]
    out = dict(bucket_spread=spread, answer_tol=tol,
               whole_model=compare_whole_model_bf16(torch, engine, engine32, rng))
    tput = throughput(engine, rng)
    for b in (1, BUCKET):
        log(f"bucket {b}: bf16 {tput[b]['pairs_per_s']:.1f} pairs/s (p50 "
            f"{tput[b]['p50_ms']:.3f} ms), f32 {tput32[b]['pairs_per_s']:.1f} pairs/s (p50 "
            f"{tput32[b]['p50_ms']:.3f} ms) in this call")
    out["throughput"] = tput
    if with_profile:
        profile(torch, engine, rng)
    pixels = rng.integers(0, 256, (BUCKET, 224, 224, 3), dtype=np.uint8)
    qs = ["what color is the cat"] * BUCKET
    out["forward_device_ms"] = {
        name: time_ms(torch, lambda e=e: e.dispatch_probs_from_pixels(pixels, qs), 12)[0]
        for name, e in (("bf16", engine), ("f32", engine32))}
    log(f"forward at bucket {BUCKET} on the device: bf16 "
        f"{out['forward_device_ms']['bf16']:.3f} ms, f32 {out['forward_device_ms']['f32']:.3f} ms")
    out["http"] = drive_http_bf16(torch, engine, rng, tol)
    del engine
    out["evaluate"] = drive_evaluate(torch, tmp, val_top1)
    out["seconds"] = time.perf_counter() - t0
    log(f"bf16 phase: {out['seconds']:.1f} s")
    return kernels, out


# ---- phase 13: multi-device -------------------------------------------------
#
# The card's machine has one H100, so the multi-rank path runs as (a) a
# launched world of one on NCCL, the production backend (the degenerate
# grid, as JAX's (1, 1) mesh on one chip), and (b) two gloo ranks sharing
# the one card (gloo runs all_reduce and broadcast on CUDA tensors; NCCL
# refuses two ranks on one device). Each rank is a process of this script
# (``--worker``) with a hard time limit; a rank that fails or outlasts it
# fails the run. (c) is one process: serving replicas on one device.

RANK_TIMEOUT_S = 600
MP_LOGIT_TOL = 1e-3     # sharded eval logits against the unsharded model's
DP_STEP_TOL = 1e-5      # dp2 step against the one-rank step: loss and BN statistics
REPLICA_TOL = 1e-4      # two replicas against one
CKPT_PROB_TOL = 1e-5    # the one-card engine on the mp2 checkpoint against the grid


def launch_ranks(task: str, world: int, tmp: str, env=None, timeout: float = RANK_TIMEOUT_S,
                 stop_on_failure: bool = True) -> list:
    """Run ``chip_smoke.py --worker task`` as ``world`` ranks, each echoing
    its output here; per rank (exit code, its JSON result or None). A rank
    still running after ``timeout`` s (or, with ``stop_on_failure``, once
    another rank failed) is killed."""
    port = _free_port()
    procs, paths = [], []
    for rank in range(world):
        out, log_path = (os.path.join(tmp, f"{task}.rank{rank}.{ext}") for ext in ("json", "log"))
        with open(log_path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--worker", task,
                 "--rank", str(rank), "--world", str(world), "--port", str(port),
                 "--tmp", tmp, "--out", out],
                cwd=REPO, env={**os.environ, **(env or {}), "PYTHONUNBUFFERED": "1"},
                stdout=f, stderr=subprocess.STDOUT))
        paths.append((out, log_path))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if stop_on_failure and any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for rank, (p, (out, log_path)) in enumerate(zip(procs, paths)):
        with open(log_path) as f:
            for line in f.read().splitlines():
                log(f"  [{task} rank {rank}] {line}")
        result = None
        if os.path.exists(out):
            with open(out) as f:
                result = json.load(f)
        results.append((p.returncode, result))
    return results


def spawn_ranks(task: str, world: int, tmp: str, env=None) -> list:
    """The JSON results of ``world`` ranks of ``task``, by rank; a rank
    that exits non-zero or outlasts RANK_TIMEOUT_S fails the run."""
    ranks = launch_ranks(task, world, tmp, env)
    bad = [(r, rc) for r, (rc, res) in enumerate(ranks) if rc != 0 or res is None]
    require(not bad, f"phase 13 {task}: ranks (rank, exit code) failed or were stopped: {bad}")
    return [res for _, res in ranks]


def _global_metrics(torch, metrics: dict, mesh) -> dict:
    """The global batch's loss and counts from this rank's shard."""
    import torch.distributed as dist

    t = torch.stack([metrics["loss"].float(), metrics["correct1"].float(),
                     metrics["correct5"].float()])
    dist.all_reduce(t, group=mesh.data_group)
    return {"loss": t[0] / mesh.data_parallel, "correct1": t[1], "correct5": t[2]}


def _max_diff(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).abs().max()) if a.numel() else 0.0


def mesh_step_equals_plain(torch, cfg, device, mesh, lr: float = 1e-4, batch: int = 32) -> dict:
    """(a) One f32 step at ``batch`` on the world-of-one NCCL mesh (the
    gradient all_reduce over one rank) against the plain single-process
    step, with deterministic cuDNN: every tensor within the plain step's
    own run-to-run difference (0 when the card is deterministic)."""
    import dataclasses

    cfg = dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)
    arrays = synthetic_batch(cfg, batch, seed=1)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        plain = one_train_step(torch, cfg, device, arrays, lr)
        again = one_train_step(torch, cfg, device, arrays, lr)
        on_mesh = one_train_step(torch, cfg, device, arrays, lr, mesh=mesh)
    worst, past, tensors = 0.0, [], 0
    for kind in ("param", "grad", "buffer"):
        def items(m):
            if kind == "buffer":
                return dict(m.named_buffers())
            return {n: (p.grad if kind == "grad" else p) for n, p in m.named_parameters()}

        ref, rep, got = items(plain[0]), items(again[0]), items(on_mesh[0])
        for name, r in ref.items():
            if r is None or not r.is_floating_point():
                continue
            d, noise = _max_diff(got[name], r), _max_diff(rep[name], r)
            worst, tensors = max(worst, d), tensors + 1
            if d > noise:
                past.append(f"{kind} {name}: {d:.3e} > run-to-run {noise:.3e}")
    loss_diff = abs(float(on_mesh[1]["loss"]) - float(plain[1]["loss"]))
    log(f"phase 13 (a): f32 step at B={batch} on the NCCL world-of-one mesh vs plain: loss "
        f"{float(on_mesh[1]['loss']):.7f} vs {float(plain[1]['loss']):.7f}; {tensors} tensors, "
        f"max difference {worst:.3e}, {len(past)} past the plain step's run-to-run difference")
    require(loss_diff <= abs(float(again[1]["loss"]) - float(plain[1]["loss"])),
            f"loss on the mesh off by {loss_diff:.3e}")
    require(not past, "mesh step vs plain: " + "; ".join(past[:5]))
    return dict(batch=batch, tensors=tensors, max_diff=worst, loss_diff=loss_diff)


def worker_nccl_world_one(torch, args) -> dict:
    """(a) A launched world of one (``RANK=0 WORLD_SIZE=1``, set by the
    parent): the train CLI at --data-parallel 1 --model-parallel 1 (bf16,
    the card's default), which joins NCCL from the launcher's variables;
    the f32 step on its mesh against the plain step; a bf16 B = 256 step's
    time on the mesh."""
    import torch.distributed as dist

    from vqa_tpu_torch.utils.config import ModelConfig

    from vqa_tpu_torch.parallel import distributed, mesh_from_config

    trainer, cli = drive_train_cli(torch, os.path.join(args.tmp, "nccl1"), argv=[
        "--synthetic", "--epochs", "1", "--subset-size", "640", "--device-aug",
        "--num-workers", "4", "--data-parallel", "1", "--model-parallel", "1"], form="_bf16")
    epoch = cli["epochs"][0]
    require((epoch["backend"], epoch["world"]) == ("nccl", 1),
            f"the train CLI trained on {epoch['backend']} at world size {epoch['world']}")
    require(trainer.mesh.shape == {"data": 1, "model": 1} and not dist.is_initialized(),
            f"mesh {trainer.mesh.shape}; the CLI left its process group: "
            f"{not dist.is_initialized()}")
    require(trainer.model.dtype == torch.bfloat16, f"trained in {trainer.model.dtype}")
    del trainer
    # the same world of one again, for the step and its time on the mesh
    device = torch.device("cuda", torch.cuda.current_device())
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    mesh = mesh_from_config()
    require(dist.get_backend() == "nccl" and mesh.data_group is not None, "no NCCL group")
    cfg = ModelConfig()
    step = mesh_step_equals_plain(torch, cfg, device, mesh)
    graph_step = mesh_graph_equals_plain(torch, cfg, device, mesh)  # phase 16 (a)
    # plain, mesh, mesh, plain in this process (the step is host-bound)
    timing = {}
    for name in ("plain", "mesh", "mesh", "plain"):
        t = train_timing(torch, cfg, device, 256, dtype=torch.bfloat16,
                         mesh=mesh if name == "mesh" else None)
        timing.setdefault(name, []).append(t)
    return dict(backend=dist.get_backend(), cli=cli, step=step, graph_step=graph_step,
                timing=timing)


def _sharded_forward(torch, cfg, device, mesh, arrays, seed: int):
    """Eval logits of a seeded f32 model placed on ``mesh`` (every rank),
    with the kernels' launches over the forward."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.models.vqa_model import shard_model

    model = shard_model(create_vqa_model(config=cfg, device=device, seed=seed), mesh)
    inputs = [torch.from_numpy(a).to(device) for a in arrays[:3]]
    torch.cuda.synchronize(device)
    ops.reset_launch_counts()
    logits = forward_logits(model, inputs[0], inputs[1].long(), inputs[2])
    torch.cuda.synchronize(device)
    heads = model.fusion.cross_attention.layers[0].cross_attention.num_heads
    return model, logits, ops.launch_counts(), heads


def worker_gloo_two_ranks(torch, args) -> dict:
    """(b) Two gloo ranks on the one card, f32 with TF32 off."""
    import dataclasses

    import torch.distributed as dist

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.models import create_vqa_model, forward_logits
    from vqa_tpu_torch.parallel import create_mesh, data_sharding, distributed, mesh_from_config
    from vqa_tpu_torch.training import evaluate
    from vqa_tpu_torch.training.train import Trainer
    from vqa_tpu_torch.utils.config import MeshConfig, ModelConfig, TrainingConfig

    device = torch.device("cuda", 0)
    distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, local_rank=0,
                           backend="gloo", device=device, timeout_s=RANK_TIMEOUT_S)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    primary = args.rank == 0
    cfg = ModelConfig()
    out = {}

    # (b1) a dp2 step at global B = 32 against the one-rank step at B = 32
    t0 = time.perf_counter()
    lr = 1e-4
    cfg0 = dataclasses.replace(cfg, dropout=0.0, answer_dropout=0.0)
    arrays = synthetic_batch(cfg0, 32, seed=1)
    mesh = create_mesh(2, 1)
    rows = data_sharding(mesh, 32)
    m_dp, r_dp = one_train_step(torch, cfg0, device, [a[rows] for a in arrays], lr, mesh=mesh)
    r_dp = _global_metrics(torch, r_dp, mesh)
    if primary:
        # the one-rank step, and its own f32 noise: the step on the batch in
        # another order and with cuDNN off (phase 10 (a)'s kind of bound)
        plain = one_train_step(torch, cfg0, device, arrays, lr)
        perm = np.random.default_rng(0).permutation(32)
        noise = [one_train_step(torch, cfg0, device, [a[perm] for a in arrays], lr)]
        with torch.backends.cudnn.flags(enabled=False):
            noise.append(one_train_step(torch, cfg0, device, arrays, lr))
        r = compare_train_steps(torch, plain, noise, (m_dp, r_dp), lr)
        bn = max(_max_diff(b, dict(plain[0].named_buffers())[n])
                 for n, b in m_dp.named_buffers() if n.endswith(("running_mean", "running_var")))
        loss_err = abs(float(r_dp["loss"]) - float(plain[1]["loss"]))
        log(f"phase 13 (b): dp2 step at global B=32 vs the one-rank step: loss err "
            f"{loss_err:.3e} (tol {DP_STEP_TOL}), BN statistics max err {bn:.3e} (tol "
            f"{DP_STEP_TOL}), gradients relative L2 {r['grad']['rel_l2_err']:.3e} (the "
            f"one-rank step's own f32 noise {r['grad']['rel_l2_noise']:.3e}), params max err "
            f"{r['param_err']:.3e} (tol 2·lr)")
        require(loss_err <= DP_STEP_TOL and bn <= DP_STEP_TOL,
                f"dp2 step: loss err {loss_err:.3e}, BN err {bn:.3e}")
        require(not r["cudnn_failures"], "dp2 step vs one rank: "
                + "; ".join(r["cudnn_failures"][:5]))
        out["dp2_step"] = dict(loss_err=loss_err, bn_err=bn, grad=r["grad"],
                               param_err=r["param_err"])
        del plain, noise
    del m_dp
    dist.barrier()
    out["dp2_step_s"] = time.perf_counter() - t0

    # (b2) mp2 and dp1×mp2 eval forwards at bucket 32 against the unsharded model
    t0 = time.perf_counter()
    batch = synthetic_batch(cfg, BUCKET, seed=3)
    launches_total = dict.fromkeys(ops.KERNELS, 0)
    if primary:
        plain = create_vqa_model(config=cfg, device=device, seed=21)
        inputs = [torch.from_numpy(a).to(device) for a in batch[:3]]
        want = forward_logits(plain, inputs[0], inputs[1].long(), inputs[2])
        del plain
    for name, mc in (("mp2", MeshConfig(model_parallel=2)),
                     ("dp1xmp2", MeshConfig(data_parallel=1, model_parallel=2))):
        mesh = mesh_from_config(mc, batch_divisor=BUCKET)
        require(mesh.shape == {"data": 1, "model": 2}, f"{name}: mesh {mesh.shape}")
        model, logits, launches, heads = _sharded_forward(torch, cfg, device, mesh, batch, 21)
        for k, v in launches.items():
            launches_total[k] += v
        require(heads == cfg.num_attention_heads // 2, f"{name}: {heads} local heads")
        for kernel, n in (("stem", 1), ("se", 4), ("cross_attention", 2)):
            require(launches[kernel] == n, f"{name} forward launched {launches}")
        if primary:
            err = _max_diff(logits, want)
            log(f"phase 13 (b): {name} eval forward at B={BUCKET}: logits max err {err:.3e} "
                f"against the unsharded model (tol {MP_LOGIT_TOL}); cross-attention on "
                f"{heads} local heads; launches {launches}")
            require(err <= MP_LOGIT_TOL, f"{name} logits off by {err:.3e}")
            out[f"{name}_logit_err"] = err
        del model
    out["mp2_forward_s"] = time.perf_counter() - t0

    # (b3) the dp2 evaluator on phase (a)'s checkpoint (f32, the default)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = evaluate.main(["--checkpoint-dir", os.path.join(args.tmp, "nccl1"), "--synthetic",
                         "--data-parallel", "2", "--device", str(device),
                         "--output-dir", os.path.join(args.tmp, "eval_dp2")])
    launches = ops.launch_counts()
    forwards = -(-res["num_samples"] // 64)
    for kernel, n in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[kernel] == n * forwards and launches[kernel + "_bf16"] == 0,
                f"dp2 evaluate: launches {launches} in {forwards} forwards")
    for k, v in launches.items():
        launches_total[k] += v
    out["evaluate_dp2"] = dict(samples=res["num_samples"], top1=res["top1_accuracy"],
                               top5=res["top5_accuracy"], loss=res["loss"], forwards=forwards,
                               launches=launches)
    out["evaluate_dp2_s"] = time.perf_counter() - t0

    # (b4) a checkpoint saved under mp2, loaded strictly into a one-card engine
    t0 = time.perf_counter()
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.tokenizer import create_tokenizer_from_questions

    ckpt = os.path.join(args.tmp, "ckpt_mp2")
    mesh = create_mesh(1, 2)
    model = create_vqa_model(config=cfg, device=device, seed=22)
    trainer = Trainer(model, [{"answer": np.zeros(8)}], [], mesh=mesh, checkpoint_dir=ckpt,
                      config=TrainingConfig(warmup_epochs=0, num_epochs=1))
    step = [torch.from_numpy(a).to(device) for a in synthetic_batch(cfg, 8, seed=4)]
    trainer.train_step(trainer.state, *step)
    trainer.save("latest", 0)
    tok = create_tokenizer_from_questions(HTTP_QUESTIONS, max_length=cfg.max_question_length,
                                          vocab_size=cfg.vocab_size, min_freq=1)
    questions = [HTTP_QUESTIONS[i % len(HTTP_QUESTIONS)] for i in range(8)]
    pixels = np.random.default_rng(5).integers(0, 256, (8, cfg.image_size, cfg.image_size, 3),
                                               np.uint8)
    ids, mask = tok.encode_batch_np(questions)
    model.eval()
    with torch.inference_mode():
        logits, _ = model(device_normalize(torch.from_numpy(pixels).to(device)),
                          torch.from_numpy(ids).to(device).long(),
                          torch.from_numpy(mask).to(device))
        grid_probs = torch.softmax(logits, -1).cpu().numpy()
    dist.barrier()
    if primary:
        tok.save(os.path.join(ckpt, "tokenizer.json"))
        engine = VQAInference(checkpoint_dir=ckpt, checkpoint_name="latest", device=device,
                              dtype=torch.float32).load()
        require(engine.model_loaded_from_checkpoint, "the engine did not load the checkpoint")
        probs = engine.predict_probs_from_pixels(pixels, questions)
        err = float(np.abs(probs - grid_probs).max())
        same = bool((probs.argmax(-1) == grid_probs.argmax(-1)).all())
        log(f"phase 13 (b): checkpoint saved on a 1×2 mesh, loaded strictly by a one-card "
            f"engine: probabilities max err {err:.3e} (tol {CKPT_PROB_TOL}) against the grid's "
            f"forward, answers equal: {same}")
        require(err <= CKPT_PROB_TOL and same, f"mp2 checkpoint in the engine: err {err:.3e}")
        out["mp2_checkpoint_prob_err"] = err
        del engine
    dist.barrier()
    out["mp2_checkpoint_s"] = time.perf_counter() - t0
    out["launches"] = launches_total
    return out


def worker_nccl_one_card(torch, args) -> dict:
    """Two NCCL ranks bound to the one card: one all_reduce. NCCL is
    expected to refuse the duplicate device; its error is the result."""
    from vqa_tpu_torch.parallel import distributed

    try:
        distributed.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, local_rank=0,
                               timeout_s=60)
        t = torch.ones(1, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        return dict(refused=False, value=float(t))
    except Exception as e:  # the expected outcome, reported
        return dict(refused=True, error=f"{type(e).__name__}: {str(e)[:400]}")


def nccl_refuses_one_card(tmp: str) -> dict:
    """Two NCCL ranks on one card: refused by NCCL (its error, or a rank
    stopped with one), or, if NCCL takes them, the right sum; anything else
    (another error, a rank that hangs) fails the run."""
    results = []
    for r, (rc, res) in enumerate(launch_ranks("nccl_one_card", 2, tmp, timeout=180,
                                               stop_on_failure=False)):
        if res is None:  # stopped by NCCL, or killed: its output is in the log above
            with open(os.path.join(tmp, f"nccl_one_card.rank{r}.log")) as f:
                res = dict(refused=True, error=f"rank exited {rc}: {f.read()[-300:]}")
        log(f"phase 13 (b): NCCL, two ranks on one card, rank {r}: "
            + (f"refused: {res['error']}" if res["refused"] else f"ran, sum {res['value']}"))
        results.append(res)
    require(all(("nccl" in res["error"].lower()) if res["refused"] else res["value"] == 2.0
                for res in results),
            "two NCCL ranks on one card: neither NCCL's refusal nor the right sum")
    return dict(refused=all(res["refused"] for res in results),
                errors=[res.get("error", "") for res in results])


def check_local_heads(torch) -> dict:
    """The cross-attention kernel at the mp2 grid's shape at full width,
    [32, 4, 20 | 49, 32] head views (f32 within 1e-5/1e-6 of the plain
    version, bf16 within one ulp), timed beside H = 8."""
    from vqa_tpu_torch import ops

    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(7)
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for h in (4, 8):
            def view(n):
                t = torch.from_numpy(rng.standard_normal((BUCKET, n, h * 32)).astype(np.float32))
                return t.to(device, dtype).view(BUCKET, n, h, 32).transpose(1, 2)

            q, k, v = view(20), view(49), view(49)
            ctx, w = ops.fused_cross_attention(q, k, v, math.sqrt(32))
            pctx, pw = ops.plain_cross_attention(q, k, v, math.sqrt(32))
            if dtype == torch.float32:
                ok = _max_diff(ctx, pctx) <= 1e-5 and _max_diff(w, pw) <= 1e-6
            else:
                ok = bf16_compare(torch, ctx, pctx)["ok"] and bf16_compare(torch, w, pw)["ok"]
            require(ok, f"cross-attention {name} at H={h} disagrees with its plain version")
            out[f"{name}_h{h}_ms"], _ = time_ms(
                torch, lambda: ops.fused_cross_attention(q, k, v, math.sqrt(32)), 50)
    log(f"phase 13: cross-attention kernel at the mp2 grid's local heads (H=4) against H=8, "
        f"ms per call: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def replicas_on_one_card(torch, cfg) -> dict:
    """(c) An engine with two replicas on cuda:0 against one replica, f32:
    answers within REPLICA_TOL at buckets 1 (rounded up to 2) and 32, each
    request's replicas launching the kernels."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.parallel import mesh_from_config
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import MeshConfig

    device = torch.device("cuda", 0)
    mesh = mesh_from_config(MeshConfig(data_parallel=2), devices=[device, device])
    one = VQAInference(model_config=cfg, device=device, dtype=torch.float32).load()
    two = VQAInference(model_config=cfg, device=device, dtype=torch.float32,
                       mesh=mesh).load()
    require(two._effective_buckets() == [2, 4, 16, 32], f"buckets {two._effective_buckets()}")
    # each replica replays graphs of its own, on static buffers of its own
    outputs = {g.output.data_ptr() for gs in two._graphs.values() for g in gs}
    require(sorted(two._graphs) == [2, 4, 16, 32]
            and all(len(gs) == 2 for gs in two._graphs.values()) and len(outputs) == 8,
            f"two replicas' graphs: {({b: len(gs) for b, gs in two._graphs.items()})}")
    rng = np.random.default_rng(8)
    out = {}
    for n in (1, BUCKET):
        pixels = rng.integers(0, 256, (n, cfg.image_size, cfg.image_size, 3), np.uint8)
        questions = [HTTP_QUESTIONS[i % len(HTTP_QUESTIONS)] for i in range(n)]
        want = one.predict_probs_from_pixels(pixels, questions)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = two.predict_probs_from_pixels(pixels, questions)
        launches = ops.launch_counts()
        err = float(np.abs(got - want).max())
        log(f"phase 13 (c): two replicas on cuda:0 at n={n} (bucket {two._bucket(n)}, "
            f"{two._bucket(n) // 2} rows each) vs one: max err {err:.3e} (tol {REPLICA_TOL}); "
            f"launches {launches}")
        require(err <= REPLICA_TOL and (got.argmax(-1) == want.argmax(-1)).all(),
                f"replicas at n={n}: err {err:.3e}")
        for kernel, per in (("stem", 1), ("se", 4), ("cross_attention", 2)):
            require(launches[kernel] == 2 * per, f"replicas at n={n}: launches {launches}")
        out[f"err_n{n}"] = err
        out[f"launches_n{n}"] = launches
    out["graphs_per_bucket"] = 2
    return out


def server_refuses_more_replicas_than_cards() -> dict:
    """(c) ``python -m vqa_tpu_torch.serving.server --data-parallel 2`` on a
    one-card machine stops with the mesh's named error."""
    proc = subprocess.run([sys.executable, "-m", "vqa_tpu_torch.serving.server",
                           "--data-parallel", "2", "--port", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    message = "mesh 2×1 needs 2 devices but only 1 are available"
    log(f"phase 13 (c): server --data-parallel 2 exited {proc.returncode}: "
        f"{proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ''}")
    require(proc.returncode != 0 and message in proc.stderr,
            f"server --data-parallel 2: rc {proc.returncode}, stderr {proc.stderr[-500:]}")
    return dict(returncode=proc.returncode)


def drive_multi_device(torch, tmp: str, bf16_timing: dict) -> dict:
    """Phase 13 at full width: (a) NCCL at world size 1, (b) two gloo ranks
    on the card, (c) serving replicas; each part's seconds logged."""
    from vqa_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()
    out, seconds = {}, {}
    t = time.perf_counter()
    (out["nccl_world_one"],) = spawn_ranks("nccl_world_one", 1, tmp, env={
        "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(_free_port())})
    seconds["a"] = time.perf_counter() - t
    timing = out["nccl_world_one"]["timing"]
    b = bf16_timing["256"]
    log("phase 13 (a): bf16 B=256 step, ms (card busy ms), plain / on the NCCL "
        "world-of-one mesh / on the mesh / plain in the rank's process: " + " / ".join(
            f"{t['step_ms']:.3f} ({t['device_busy_ms_per_step']:.3f})"
            for t in (timing["plain"][0], *timing["mesh"], timing["plain"][1]))
        + f"; phase 12 (c)'s plain step in this process {b['step_ms']:.3f} "
        f"({b['device_busy_ms_per_step']:.3f}); {seconds['a']:.1f} s")
    t = time.perf_counter()
    out["nccl_one_card"] = nccl_refuses_one_card(tmp)
    ranks = spawn_ranks("gloo_two_ranks", 2, tmp)
    seconds["b"] = time.perf_counter() - t
    out["gloo_two_ranks"] = ranks[0]
    # the one-rank evaluator on the same checkpoint, in this process
    from vqa_tpu_torch.training import evaluate

    alone = evaluate.main(["--checkpoint-dir", os.path.join(tmp, "nccl1"), "--synthetic",
                           "--device", str(torch.device("cuda", 0)),
                           "--output-dir", os.path.join(tmp, "eval_one")])
    dp2 = ranks[0]["evaluate_dp2"]
    log(f"phase 13 (b): dp2 evaluator top-1 {dp2['top1']:.4f} top-5 {dp2['top5']:.4f} on "
        f"{dp2['samples']} samples, one rank top-1 {alone['top1_accuracy']:.4f} top-5 "
        f"{alone['top5_accuracy']:.4f}; {seconds['b']:.1f} s")
    require(dp2["samples"] == alone["num_samples"] and dp2["top1"] == alone["top1_accuracy"]
            and dp2["top5"] == alone["top5_accuracy"], "dp2 evaluator vs one rank")
    t = time.perf_counter()
    out["local_heads"] = check_local_heads(torch)
    out["replicas"] = replicas_on_one_card(torch, cfg)
    out["server"] = server_refuses_more_replicas_than_cards()
    seconds["c"] = time.perf_counter() - t
    out["phase_seconds"] = seconds
    log("phase 13: " + ", ".join(f"({k}) {v:.1f} s" for k, v in seconds.items()))
    return out


# ---- phase 14: host prep, the off-path modules, the tools -------------------

NATIVE_SIZES = (64, 224, 512, 1024)    # upload sides timed for decode + resize to 224
NATIVE_ODD = ((37, 501), (333, 257), (1, 1), (300, 300))  # bit identity at odd shapes
HOST_BATCH = 32                         # uploads of the batch timing, at 512 px
MODULE_SHAPES = ((BUCKET, 512, 7, 7), (BUCKET, 64, 56, 56))  # backbone stage outputs
MODULE_TOL = 1e-4       # a module's card forward against its CPU forward, f32, TF32 off
SPATIAL_TRAIN_IMAGES = 1200  # tools/make_vqa_corpus.py --spatial --seed 42
SPATIAL_VAL_IMAGES = 250     # ... --seed 4242, held out
SPATIAL_EPOCHS = 16          # scripts/run_ablation.py's default
JAX_FAITHFULNESS_MEAN = 0.4138  # docs/ATTENTION_FAITHFULNESS.json: JAX's, its own corpus
SOAK_REQUESTS, SOAK_CLIENTS = 2000, 16
SUPERVISED_REQUESTS, SUPERVISED_CLIENTS = 600, 8
SUPERVISED_RECYCLE_MB = 512  # below a full-width worker's RSS at ready (~6 GB)


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def host_prep(torch, rng, device="cuda") -> dict:
    """(a) The native resampler on this host: bit identity with PIL and with
    the port's PIL path; decode + resize to 224 per image at 64-1024 px, PIL
    on one thread against native; a batch of 32 uploads at 512 px, the pool
    against PIL in a loop; and the bf16 engine's ``_preprocess_images`` over
    one bucket-32 group of the soak's uploads beside the dispatch host ms at
    bucket 32."""
    from PIL import Image

    from vqa_tpu_torch import native
    from vqa_tpu_torch.data import preprocess
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.tools import soak_test
    from vqa_tpu_torch.utils.config import ModelConfig

    require(native.available(), f"native resampler unavailable: {native.build_error()}")
    pil_path = mock.patch.object(native, "available", lambda: False)

    def pil_resize(img, h, w):
        return np.asarray(img.resize((w, h), Image.BILINEAR))

    # bit identity: uploads at each size, odd shapes, the batch path
    uploads = {s: image_bytes(rng, s, s, "JPEG") for s in NATIVE_SIZES}
    for s, data in uploads.items():
        img = preprocess.load_image(data)
        got = native.resize_bilinear(np.asarray(img), 224, 224)
        with pil_path:
            port_pil = preprocess.resize_to_uint8(data, 224)
        require(np.array_equal(got, pil_resize(img, 224, 224))
                and np.array_equal(got, preprocess.resize_to_uint8(data, 224))
                and np.array_equal(got, port_pil), f"native resize at {s} px differs from PIL")
    for (h, w) in NATIVE_ODD:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for dh, dw in ((224, 224), (7, 13), (256, 256)):
            require(np.array_equal(native.resize_bilinear(arr, dh, dw),
                                   pil_resize(Image.fromarray(arr), dh, dw)),
                    f"native resize {h}x{w} -> {dh}x{dw} differs from PIL")
    mix = soak_test.upload_mix()
    batch = preprocess.resize_batch_to_uint8(mix, 224)
    with pil_path:
        require(np.array_equal(batch, preprocess.resize_batch_to_uint8(mix, 224)),
                "the batch path differs from PIL's")
    log(f"phase 14 (a): native resize bit-identical to PIL at {NATIVE_SIZES} px, "
        f"{len(NATIVE_ODD) * 3} odd shapes and the batch path; os.cpu_count() {os.cpu_count()}")

    # decode + resize to 224, one image
    per_image = {}
    for s, data in uploads.items():
        reps = 40 if s <= 224 else 15
        decode = _median_ms(lambda: preprocess.load_image(data), reps)
        pil = _median_ms(lambda: pil_resize(preprocess.load_image(data), 224, 224), reps)
        nat = _median_ms(lambda: native.resize_bilinear(
            np.asarray(preprocess.load_image(data)), 224, 224), reps)
        per_image[str(s)] = dict(decode_ms=decode, pil_ms=pil, native_ms=nat,
                                 speedup=pil / nat)
        log(f"phase 14 (a): {s} px JPEG -> 224: decode {decode:.3f} ms; decode + resize "
            f"PIL {pil:.3f} ms, native {nat:.3f} ms ({pil / nat:.2f}x)")

    # a batch of 32 uploads at 512 px: the pool against PIL in a loop
    group512 = [image_bytes(rng, 512, 512, "JPEG") for _ in range(HOST_BATCH)]
    decoded = [np.asarray(preprocess.load_image(d)) for d in group512]
    batch_nat = _median_ms(lambda: preprocess.resize_batch_to_uint8(group512, 224), 5)
    with pil_path:
        batch_pil = _median_ms(lambda: preprocess.resize_batch_to_uint8(group512, 224), 5)
    resize_nat = _median_ms(lambda: native.resize_bilinear_batch(decoded, 224, 224), 10)
    resize_pil = _median_ms(lambda: [pil_resize(Image.fromarray(a), 224, 224)
                                     for a in decoded], 10)
    log(f"phase 14 (a): {HOST_BATCH} uploads at 512 px, decode + resize: native pool "
        f"{batch_nat:.3f} ms, PIL loop {batch_pil:.3f} ms ({batch_pil / batch_nat:.2f}x); "
        f"resize alone: pool {resize_nat:.3f} ms, PIL loop {resize_pil:.3f} ms "
        f"({resize_pil / resize_nat:.2f}x) on {os.cpu_count()} cores")

    # one bucket-32 group of the soak's uploads through the bf16 engine
    engine = VQAInference(model_config=ModelConfig(), device=device).load()
    group = [mix[int(rng.integers(len(mix)))] for _ in range(BUCKET)]
    prep_nat = _median_ms(lambda: engine._preprocess_images(group), 9)
    with pil_path:
        prep_pil = _median_ms(lambda: engine._preprocess_images(group), 9)
    dispatch = dispatch_timing(torch, engine, rng)
    host = dispatch["dispatch_host_ms"]
    share = prep_nat / (prep_nat + host)
    log(f"phase 14 (a): a bucket-32 group of the soak's uploads: _preprocess_images native "
        f"{prep_nat:.3f} ms, PIL {prep_pil:.3f} ms; bf16 dispatch host {host:.3f} ms "
        f"(forward {dispatch['forward_device_ms']:.3f} ms on the device): decode + resize "
        f"is {100 * share:.1f}% of the group's host time ({100 * prep_pil / (prep_pil + host):.1f}% "
        f"with PIL)")
    del engine
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return dict(cpu_count=os.cpu_count(), per_image=per_image,
                batch32_512px=dict(native_ms=batch_nat, pil_ms=batch_pil,
                                   resize_native_ms=resize_nat, resize_pil_ms=resize_pil),
                group32=dict(preprocess_native_ms=prep_nat, preprocess_pil_ms=prep_pil,
                             dispatch=dispatch, prep_share_of_host=share,
                             prep_share_of_host_pil=prep_pil / (prep_pil + host)))


def _seeded_module(torch, cls, channels: int, rng):
    """``cls(channels)`` in eval mode with seeded weights (std 0.1) and, for
    SelfAttention2D, gamma 0.5 (at its initial 0 the module is the
    identity)."""
    m = cls(channels).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1))
        if hasattr(m, "gamma"):
            m.gamma.fill_(0.5)
    return m


def attention_modules_on_card(torch, rng, device="cuda") -> tuple:
    """(b) CBAMBlock and SelfAttention2D at the backbone's stage-output
    shapes: the card's f32 forward (TF32 off) against the same module's CPU
    forward within 1e-4; CBAMBlock launches the SE kernel once per eval call,
    in f32 and in bf16. Returns the numbers and (b)'s kernel launches."""
    import copy

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.models import CBAMBlock, SelfAttention2D

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, out = torch.device(device), {}
    cases = []
    for shape in MODULE_SHAPES:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
        for cls in (CBAMBlock, SelfAttention2D):
            cpu = _seeded_module(torch, cls, shape[1], rng)
            cases.append((f"{cls.__name__}{list(shape)}", cpu, copy.deepcopy(cpu).to(dev), x))
    for name, _, card, x in cases:  # timed first: these calls are not counted
        xd = x.to(dev)
        device_ms, call_ms = time_ms(torch, lambda: card(xd), 10)
        out[name] = dict(ms=device_ms, call_ms=call_ms)
    ops.reset_launch_counts()
    for name, cpu, card, x in cases:
        with torch.no_grad():
            want = cpu(x)
            before = ops.launch_counts()
            got = card(x.to(dev))
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            err = max_err(got.cpu(), want)
            require(got.shape == x.shape and bool(torch.isfinite(got).all()),
                    f"{name}: shape {tuple(got.shape)} or non-finite values")
            require(err <= MODULE_TOL, f"{name}: card vs CPU max err {err:.3e} > {MODULE_TOL}")
            se_calls = {"se": 1} if name.startswith("CBAM") else {}
            require(delta == {k: se_calls.get(k, 0) for k in delta},
                    f"{name}: launches {delta} in one eval call")
            out[name].update(max_abs_err=err, launches=delta)
            if name.startswith("CBAM"):  # the bf16 form, once per call too
                card.set_compute_dtype(torch.bfloat16)
                before = ops.launch_counts()
                got16 = card(x.to(dev, torch.bfloat16))
                torch.cuda.synchronize()
                delta16 = {k: v - before[k] for k, v in ops.launch_counts().items()}
                require(delta16 == {k: int(k == "se_bf16") for k in delta16}
                        and bool(torch.isfinite(got16).all()),
                        f"{name} bf16: launches {delta16} in one eval call")
                out[name].update(bf16_vs_f32=max_err(got16.float().cpu(), want),
                                 bf16_launches=delta16)
        log(f"phase 14 (b): {name}: card vs CPU max err {err:.3e} (tol {MODULE_TOL:.0e}), "
            f"{out[name]['ms']:.3f} ms on the device per call ({out[name]['call_ms']:.3f} "
            f"by events); launches per eval call {delta}"
            + (f", bf16 {out[name]['bf16_launches']} (bf16 vs f32 {out[name]['bf16_vs_f32']:.3e})"
               if name.startswith("CBAM") else ""))
    launches = ops.launch_counts()
    del cases
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out, launches


def faithfulness_on_card(torch, tmp: str, rng, device="cuda", extra=()) -> tuple:
    """(c) A spatial train corpus (seed 42) and a held-out one (seed 4242)
    from tools/make_vqa_corpus.py, the val corpus written twice (its decoded
    images and JSON equal); the train CLI on the train corpus at full width
    (bf16, the card's default); tools/attention_faithfulness.py on the val
    corpus: mean queried-quadrant mass above the uniform 0.25, each eval
    forward launching the f32 forms 1, 4 and 2 times; then
    tools/visualize_attention.py on one val image. Returns the numbers and
    the tools' kernel launches."""
    from PIL import Image

    from vqa_tpu_torch import ops
    from vqa_tpu_torch.tools import attention_faithfulness, make_vqa_corpus, visualize_attention

    t0 = time.perf_counter()
    corpora = {}
    for name, n, seed in (("train", SPATIAL_TRAIN_IMAGES, 42), ("val", SPATIAL_VAL_IMAGES, 4242),
                          ("val_again", SPATIAL_VAL_IMAGES, 4242)):
        d = os.path.join(tmp, name)
        with contextlib.redirect_stdout(io.StringIO()):
            make_vqa_corpus.main(["--out", d, "--num-images", str(n), "--seed", str(seed),
                                  "--spatial"])
        with open(os.path.join(d, "corpus_meta.json")) as f:
            corpora[name] = json.load(f)
    val, again = os.path.join(tmp, "val"), os.path.join(tmp, "val_again")
    for f in ("questions.json", "annotations.json", "corpus_meta.json"):
        with open(os.path.join(val, f)) as a, open(os.path.join(again, f)) as b:
            require(a.read() == b.read(), f"make_vqa_corpus: {f} differs between two writes")
    for name in sorted(os.listdir(os.path.join(val, "images"))):
        require(np.array_equal(np.asarray(Image.open(os.path.join(val, "images", name))),
                               np.asarray(Image.open(os.path.join(again, "images", name)))),
                f"make_vqa_corpus: {name} decodes differently between two writes")
    corpus_s = time.perf_counter() - t0
    log(f"phase 14 (c): corpora {corpora['train']} and {corpora['val']} in {corpus_s:.1f} s; "
        f"the val corpus written twice: equal JSON and decoded images")

    train = os.path.join(tmp, "train")
    ckpt = os.path.join(tmp, "ckpt")
    _, cli = drive_train_cli(torch, ckpt, form="_bf16", argv=[
        "--questions", os.path.join(train, "questions.json"),
        "--annotations", os.path.join(train, "annotations.json"),
        "--images-dir", os.path.join(train, "images"), "--subset-size", "999999",
        "--epochs", str(SPATIAL_EPOCHS), "--batch-size", "64", "--device-aug",
        "--num-workers", "4", "--seed", "42", *extra])

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_json = os.path.join(tmp, "faithfulness.json")
    with contextlib.redirect_stdout(io.StringIO()):
        attention_faithfulness.main(["--checkpoint-dir", ckpt, "--corpus", val,
                                     "--out", out_json, "--device", device])
    with open(out_json) as f:
        faith = json.load(f)
    faith_s = time.perf_counter() - t0
    faith_launches = ops.launch_counts()
    forwards = -(-faith["overall"]["n"] // 64)
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(faith_launches[name] == per_forward * forwards
                and faith_launches[name + "_bf16"] == 0,
                f"faithfulness: launches {faith_launches} in {forwards} forwards")
    mean = faith["overall"]["mean"]
    log(f"phase 14 (c): attention faithfulness over {faith['overall']['n']} held-out spatial "
        f"questions: mean queried-quadrant mass {mean:.4f} (uniform 0.25; JAX's own, another "
        f"corpus and checkpoint: {JAX_FAITHFULNESS_MEAN}), median {faith['overall']['median']}, "
        f"above uniform {faith['overall']['frac_above_uniform']}, top-1 on them "
        f"{faith['top1_on_spatial_questions']}; by position "
        + ", ".join(f"{k} {v['mean']}" for k, v in faith["by_position"].items())
        + f"; {forwards} forwards in {faith_s:.1f} s, launches {faith_launches}")
    require(mean > 0.25, f"mean queried-quadrant mass {mean} is not above the uniform 0.25")

    with open(os.path.join(val, "questions.json")) as f:
        q = next(q for q in json.load(f)["questions"] if " in the " in q["question"])
    viz = os.path.join(tmp, "viz")
    before = ops.launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        visualize_attention.main(["--checkpoint-dir", ckpt, "--out", viz, "--device", device,
                                  "--question",
                                  q["question"], "--image", os.path.join(
                                      val, "images", f"{q['image_id']:012d}.jpg")])
    launches = ops.launch_counts()
    viz_delta = {k: v - before[k] for k, v in launches.items()}
    pngs = sorted(os.listdir(viz))
    log(f"phase 14 (c): visualize_attention on '{q['question']}': {pngs}; launches {viz_delta}")
    require(pngs == ["cross_attention_layer0.png", "cross_attention_layer1.png",
                     "cross_attention_mean.png"], f"visualize_attention wrote {pngs}")
    require(viz_delta == {"stem": 1, "se": 4, "cross_attention": 2, "stem_bf16": 0,
                          "se_bf16": 0, "cross_attention_bf16": 0},
            f"visualize_attention: launches {viz_delta}")
    return dict(corpora=corpora, corpus_s=corpus_s, train=cli, faithfulness=faith,
                faithfulness_s=faith_s, forwards=forwards + 1, pngs=pngs), launches


def soak_on_card(torch, extra=()) -> tuple:
    """(d) tools/soak_test.py in this process on the bf16 engine at full
    width: passed, no contract violation, no stuck waiter, RSS plateaued;
    every forward launched the bf16 forms 1, 4 and 2 times and no f32 form.
    Returns the result and its kernel launches."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.tools import soak_test

    ops.reset_launch_counts()
    res = soak_test.run(soak_test.parse_args(
        ["--requests", str(SOAK_REQUESTS), "--clients", str(SOAK_CLIENTS), *extra]))
    launches = ops.launch_counts()
    forwards = launches["stem_bf16"]
    log(f"phase 14 (d): soak, {res['requests_total']} of {res['expected_total']} requests "
        f"from {SOAK_CLIENTS} clients in {res['wall_s']} s ({res['throughput_rps']} requests/s), "
        f"/predict p50 {res['predict_p50_ms']} ms, p99 {res['predict_p99_ms']} ms; windows "
        f"{res['latency_drift_windows']}; RSS first {res['rss_start_mb']} MB, last "
        f"{res['rss_end_mb']}, max {res['rss_max_mb']}, growth over the last third "
        f"{res['rss_growth_last_third_pct']}%; windows {res['rss_windows']}; mix "
        f"{res['mix_counts']}; violations {res['contract_violations']}; stuck "
        f"{res['stuck_waiters']}; {forwards} forwards, launches {launches}")
    require(res["passed"] and res["contract_violations"] == {} and res["stuck_waiters"] == 0
            and res["rss_plateaued"], "the in-process soak did not pass")
    require(forwards > 0 and launches["se_bf16"] == 4 * forwards
            and launches["cross_attention_bf16"] == 2 * forwards
            and launches["stem"] == launches["se"] == launches["cross_attention"] == 0,
            f"soak: launches {launches}")
    return res, launches


def supervised_soak_on_card(extra=()) -> dict:
    """(e) tools/soak_test.py under the recycle supervisor, full-width bf16
    workers on the card and a bound below one worker's RSS: every request
    answered within the contract, and a recycle begun."""
    from vqa_tpu_torch.tools import soak_test

    res = soak_test.run(soak_test.parse_args(
        ["--requests", str(SUPERVISED_REQUESTS), "--clients", str(SUPERVISED_CLIENTS),
         "--supervisor-recycle-mb", str(SUPERVISED_RECYCLE_MB), *extra]))
    kinds = [e["supervisor"] for e in res["recycles"]]
    log(f"phase 14 (e): supervised soak, {res['requests_total']} of {res['expected_total']} "
        f"requests from {SUPERVISED_CLIENTS} clients in {res['wall_s']} s "
        f"({res['throughput_rps']} requests/s), p50 {res['predict_p50_ms']} ms, p99 "
        f"{res['predict_p99_ms']} ms; recycle events {kinds}; tree RSS first "
        f"{res['rss_start_mb']} MB, max {res['rss_max_mb']}, last {res['rss_end_mb']}; "
        f"violations {res['contract_violations']}; passed {res['passed']} (rss_plateaued "
        f"{res['rss_plateaued']})")
    require(res["requests_total"] == res["expected_total"] == SUPERVISED_REQUESTS
            and res["contract_violations"] == {}, "the supervised soak lost requests")
    require("recycle_start" in kinds, f"no recycle began: {kinds}")
    return res


def drive_tools(torch, rng, device="cuda", extra=()) -> tuple:
    """Phase 14: (a) host prep, (b) CBAMBlock and SelfAttention2D, (c)
    faithfulness and visualization, (d) the soak, (e) the supervised soak;
    each part's seconds logged. Returns the ``tools`` line and each kernel
    form's launches over (b)-(d). ``device`` and ``extra`` (flags for the
    train CLI and the soak, such as ``--tiny --device cpu``) let the phase
    be rehearsed on the CPU."""
    out, seconds = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t
        log(f"phase 14 ({name}): {seconds[name]:.1f} s")
        return result

    out["host_prep"] = part("a", lambda: host_prep(torch, rng, device))
    out["modules"], launches_b = part("b", lambda: attention_modules_on_card(torch, rng, device))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools.") as tmp:
        out["faithfulness"], launches_c = part("c", lambda: faithfulness_on_card(
            torch, tmp, rng, device, extra))
    out["soak"], launches_d = part("d", lambda: soak_on_card(torch, extra))
    out["supervised_soak"] = part("e", lambda: supervised_soak_on_card(extra))
    out["phase_seconds"] = seconds
    launches = {k: launches_b[k] + launches_c[k] + launches_d[k] for k in launches_b}
    return out, launches


# ---- phase 15: the engine's CUDA graphs, the roofline, the supervisor's default

GRAPH_TOL = 1e-4      # f32 replay against the eager forward (tests/test_torch_engine.py:72)
ALIAS_ROWS = 70       # three chunks at bucket 32
TIMING_ROUNDS = 4     # (d): eager and graph in turns, the order flipped each round
B1_CALLS, B32_CALLS, DISPATCH_CALLS = 20, 10, 5
IDLE_S = 30.0         # (g): a default-flag supervisor over a full-width worker, idle
RSS_GROUPS = (        # (g): a worker's RSS by mapping, first match wins
    ("cudnn", ("libcudnn",)),
    ("cublas", ("libcublas",)),
    ("torch_cuda", ("libtorch_cuda", "libc10_cuda")),
    ("cuda_driver", ("libcuda.so", "libnvidia-")),
    ("other_cuda_libraries", ("libnccl", "libcusparse", "libcufft", "libcurand", "libcusolver",
                              "libnvrtc", "libnvJitLink", "libcupti", "libcudart",
                              "libnvToolsExt", "libcufile", "libnvperf", "libcuda")),
    ("torch_cpu", ("libtorch", "libc10", "libgomp", "libshm")),
    ("device_files", ("/dev/nvidia",)),
)


def rss_breakdown(pid: int) -> dict:
    """MB of ``pid``'s RSS by mapping (``/proc/<pid>/smaps``): the CUDA
    libraries' images by library, torch's CPU libraries, the device files'
    mappings (the CUDA context's, pinned host memory the driver maps),
    other files (Python, numpy, PIL, the kernels' library), the heap,
    anonymous memory (malloc's arenas, host tensors, the driver's own) and
    the rest (stack, vdso); ``total`` is their sum; ``files`` the MB of
    each file that holds at least 20 MB."""
    out = dict.fromkeys([g for g, _ in RSS_GROUPS]
                        + ["other_files", "heap", "anonymous", "other"], 0.0)
    files = {}
    group, name = "other", ""
    with open(f"/proc/{pid}/smaps") as f:
        for line in f:
            head = line.split(None, 5)
            if len(head) >= 5 and "-" in head[0] and not head[0].endswith(":"):
                name = head[5].strip() if len(head) > 5 else ""
                group = next((g for g, keys in RSS_GROUPS if any(k in name for k in keys)),
                             None) or ("heap" if name == "[heap]" else
                                       "anonymous" if not name or name.startswith("[anon")
                                       else "other" if name.startswith("[")
                                       else "other_files")
            elif line.startswith("Rss:"):
                mb = int(line.split()[1]) / 1024.0
                out[group] += mb
                if name.startswith("/"):
                    files[os.path.basename(name)] = files.get(os.path.basename(name), 0.0) + mb
    out["total"] = sum(out.values())
    out["files"] = {k: v for k, v in sorted(files.items(), key=lambda kv: -kv[1]) if v >= 20}
    return out


def graphs_match_eager(engine, rng, tol: float) -> dict:
    """(a) Every effective bucket of every replica is a graph, and at each
    bucket the replayed probabilities on inputs the capture never saw are
    within ``tol`` of the eager forward's (``_dispatch_eager``) on the
    same inputs. Returns the max abs err per bucket."""
    size = engine.model.config.image_size
    buckets = engine._effective_buckets()
    shape = {b: len(gs) for b, gs in (engine._graphs or {}).items()}
    require(shape == {b: len(engine.replicas) for b in buckets},
            f"{engine.dtype} engine: graphs per bucket {shape}, buckets {buckets}")
    errs = {}
    for b in buckets:
        pixels = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
        qs = [HTTP_QUESTIONS[i % 5] for i in range(b)]
        got, _ = engine.dispatch_probs_from_pixels(pixels, qs)
        want, _ = engine._dispatch_eager(pixels, qs)
        errs[b] = max_err(got, want)
    log(f"phase 15 (a): {engine.dtype} engine, replay vs eager at buckets {tuple(errs)}: "
        + ", ".join(f"{b}: {e:.3e}" for b, e in errs.items()) + f" (tol {tol:.1e})")
    require(max(errs.values()) <= tol, f"{engine.dtype} replay vs eager: {errs}")
    return errs


def chunks_do_not_alias(engine, rng) -> float:
    """(b) 70 requests through ``predict_probs_from_pixels`` (three chunks,
    all dispatched before the first is fetched) against each chunk
    dispatched and fetched alone."""
    size = engine.model.config.image_size
    pixels = rng.integers(0, 256, (ALIAS_ROWS, size, size, 3), dtype=np.uint8)
    qs = [HTTP_QUESTIONS[i % 5] for i in range(ALIAS_ROWS)]
    got = engine.predict_probs_from_pixels(pixels, qs)
    alone = np.concatenate([engine.predict_probs_from_pixels(pixels[i:i + BUCKET],
                                                             qs[i:i + BUCKET])
                            for i in range(0, ALIAS_ROWS, BUCKET)])
    err = float(np.abs(got - alone).max())
    distinct = len({int(r.argmax()) for r in got}) > 1 or float(np.ptp(got[:, 0])) > 0
    log(f"phase 15 (b): {engine.dtype} engine, {ALIAS_ROWS} requests in one call vs its "
        f"chunks alone: max err {err:.3e}; rows distinct: {distinct}")
    require(err <= 1e-6 and distinct, f"chunked dispatches alias: err {err:.3e}")
    return err


def launches_per_replay(torch, engine) -> dict:
    """(c) One dispatch at each effective bucket: the forms of the engine's
    dtype launched 1, 4 and 2 times per replayed forward, the others not."""
    from vqa_tpu_torch import ops

    size = engine.model.config.image_size
    buckets = engine._effective_buckets()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b in buckets:
        engine.dispatch_probs_from_pixels(np.zeros((b, size, size, 3), np.uint8),
                                          ["what is this"] * b)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    suffix = "_bf16" if engine.dtype == torch.bfloat16 else ""
    want = {**dict.fromkeys(launches, 0),
            **{k + suffix: per * len(buckets) for k, per in
               (("stem", 1), ("se", 4), ("cross_attention", 2))}}
    log(f"phase 15 (c): {engine.dtype} engine, {len(buckets)} replayed forwards: launches "
        f"{launches}")
    require(launches == want, f"launches per replay: {launches}, want {want}")
    return launches


def eager_vs_graph(torch, engine, rng, rounds: int = TIMING_ROUNDS) -> dict:
    """(d) The eager forward (``_dispatch_eager``) and the graphs, in turns
    (eager first in even rounds, the graph first in odd ones): bucket-1
    latency through ``predict_probs_from_pixels`` (p50/p90 of each round's
    calls and of all of them), bucket-32 pairs/s, the host ms of one
    bucket-32 dispatch issued with the card idle, and the card's busy share
    of a profiled window of bucket-32 calls (device time over wall time,
    with its device ms per call). Each metric is kept per round: its spread."""
    from torch.profiler import ProfilerActivity, profile

    size = engine.model.config.image_size
    p1 = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    p32 = rng.integers(0, 256, (BUCKET, size, size, 3), dtype=np.uint8)
    q1, q32 = HTTP_QUESTIONS[:1], [HTTP_QUESTIONS[i % 5] for i in range(BUCKET)]

    def mode(name):
        return (mock.patch.object(engine, "dispatch_probs_from_pixels", engine._dispatch_eager)
                if name == "eager" else contextlib.nullcontext())

    def timed(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    keys = ("b1_ms", "b1_p50_ms", "b1_p90_ms", "pairs_per_s_b32", "dispatch_host_ms_b32",
            "busy_share_b32", "device_ms_b32")
    res = {m: {k: [] for k in keys} for m in ("eager", "graph")}
    for m in res:
        with mode(m):
            for _ in range(3):
                engine.predict_probs_from_pixels(p1, q1)
                engine.predict_probs_from_pixels(p32, q32)
    for r in range(rounds):
        for m in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            out = res[m]
            with mode(m):
                b1 = sorted(timed(lambda: engine.predict_probs_from_pixels(p1, q1), B1_CALLS))
                out["b1_ms"] += b1
                out["b1_p50_ms"].append(statistics.median(b1))
                out["b1_p90_ms"].append(b1[int(0.9 * (len(b1) - 1))])
                b32 = timed(lambda: engine.predict_probs_from_pixels(p32, q32), B32_CALLS)
                out["pairs_per_s_b32"].append(1e3 * BUCKET * B32_CALLS / sum(b32))
                host = []
                for _ in range(DISPATCH_CALLS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.dispatch_probs_from_pixels(p32, q32)
                    host.append(1e3 * (time.perf_counter() - t0))
                    torch.cuda.synchronize()
                out["dispatch_host_ms_b32"].append(statistics.median(host))
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(B32_CALLS):
                        engine.predict_probs_from_pixels(p32, q32)
                    wall = time.perf_counter() - t0
                busy_us = sum(e.self_device_time_total for e in device_events(prof))
                out["busy_share_b32"].append(busy_us / 1e6 / wall)
                out["device_ms_b32"].append(busy_us / 1e3 / B32_CALLS)
    summary = {}
    for m, out in res.items():
        b1 = sorted(out.pop("b1_ms"))
        summary[m] = dict(b1_p50_ms_all=statistics.median(b1),
                          b1_p90_ms_all=b1[int(0.9 * (len(b1) - 1))], b1_calls=len(b1),
                          rounds=out, **{k: statistics.median(v) for k, v in out.items()})
    for k in keys[1:]:
        e, g = res["eager"][k], res["graph"][k]
        log(f"phase 15 (d): {engine.dtype} {k}: eager {statistics.median(e):.4g} "
            f"[{min(e):.4g}-{max(e):.4g}], graph {statistics.median(g):.4g} "
            f"[{min(g):.4g}-{max(g):.4g}] (median [range] of {rounds} rounds)")
    log(f"phase 15 (d): {engine.dtype} bucket 1 over all {summary['graph']['b1_calls']} calls: "
        f"eager p50 {summary['eager']['b1_p50_ms_all']:.3f} ms p90 "
        f"{summary['eager']['b1_p90_ms_all']:.3f}, graph p50 "
        f"{summary['graph']['b1_p50_ms_all']:.3f} p90 {summary['graph']['b1_p90_ms_all']:.3f}")
    require(all(v > 0 for v in res["graph"]["busy_share_b32"]),
            "a profiled window of graph replays saw no device time")
    return summary


def roofline_floor(timing: dict) -> dict:
    """(f) The roofline floor of one bucket-32 forward (tools/roofline.py at
    the H100's peaks) beside the graphed forward's device ms from (d)."""
    from vqa_tpu_torch.tools import roofline

    out = {}
    for dtype, t in timing.items():
        floor = roofline.forward_floor_ms(BUCKET, dtype)
        device_ms = t["graph"]["device_ms_b32"]
        out[dtype] = dict(floor, graph_device_ms=device_ms,
                          share_of_floor=floor["overlap_ms"] / device_ms)
        log(f"phase 15 (f): {dtype} bucket-{BUCKET} forward: roofline floor "
            f"{floor['overlap_ms']:.4f} ms ({floor['bound_by']}; additive "
            f"{floor['additive_ms']:.4f}; {floor['flops'] / 1e9:.1f} GFLOP, "
            f"{floor['bytes'] / 1e6:.1f} MB) against the graphed forward's "
            f"{device_ms:.4f} ms on the device ({100 * floor['overlap_ms'] / device_ms:.1f}%)")
    return out


def worker_rss_stages(torch, args) -> dict:
    """(g) A full-width bf16 engine built step by step in a process of its
    own, as a server worker builds it: RSS and its split by mapping after
    the imports, the CUDA context, the model on the card (its graphs not yet
    captured), one eager forward per bucket (cuDNN's and cuBLAS's first
    use), the graphs, the warmup, and glibc's ``malloc_trim`` (the heap
    freed but kept). PyTorch's pinned host allocator's byte counts beside
    it."""
    import ctypes

    from vqa_tpu_torch.serving import server  # noqa: F401  (what a worker imports)
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.serving.supervisor import rss_mb
    from vqa_tpu_torch.utils.config import ModelConfig

    pid, stages = os.getpid(), {}

    def mark(name):
        stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
        stages[name] = dict(rss_mb=rss_mb(pid), split=rss_breakdown(pid),
                            pinned={k: v for k, v in stats.items() if "bytes" in k})

    mark("imports")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    mark("cuda_context")
    engine = VQAInference(model_config=ModelConfig(), device="cuda")
    engine._graphed = False  # load the model alone first
    engine.load()
    torch.cuda.synchronize()
    mark("model_on_card")
    size = engine.model.config.image_size
    for b in engine._effective_buckets():
        engine._dispatch_eager(np.zeros((b, size, size, 3), np.uint8), ["what is this"] * b)
    torch.cuda.synchronize()
    mark("eager_forwards")
    engine._graphed = True
    engine._capture_graphs()
    torch.cuda.synchronize()
    mark("graphs_captured")
    engine.warmup()
    torch.cuda.synchronize()
    mark("warmed")
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    mark("after_malloc_trim")
    return stages


def default_supervisor_idle(rng, tmp: str, idle_s: float = IDLE_S,
                            worker_args=("--device", "cuda")) -> dict:
    """(g) ``python -m vqa_tpu_torch.serving.supervisor`` with its default
    bound over a full-width worker on the card (the default engine, bf16,
    its graphs captured before the ready line): the worker's RSS at ready
    and its split by mapping, then ``idle_s`` seconds idle after one
    request, sampling its RSS: no ``recycle_start``. Meanwhile
    ``worker_rss_stages`` runs in a process of its own. Then SIGTERM: exit
    0, no worker left."""
    import signal

    from vqa_tpu_torch.serving.supervisor import DEFAULT_RECYCLE_RSS_MB, rss_mb

    cmd = [sys.executable, "-m", "vqa_tpu_torch.serving.supervisor", "--host", "127.0.0.1",
           "--port", "0", *worker_args]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    events, ready_seen = [], threading.Event()

    def pump():
        for line in proc.stdout:
            log(f"  supervisor| {line.rstrip()}")
            if line.startswith('{"supervisor"'):
                events.append(json.loads(line))
                if events[-1]["supervisor"] == "ready":
                    ready_seen.set()

    threading.Thread(target=pump, daemon=True).start()
    stages_out = os.path.join(tmp, "rss_stages.json")
    stages_proc = None
    try:
        require(ready_seen.wait(300), f"default supervisor: no ready event ({proc.poll()=})")
        ready = next(e for e in events if e["supervisor"] == "ready")
        pid, bound = ready["pid"], ready["recycle_rss_mb"]
        require(bound == DEFAULT_RECYCLE_RSS_MB, f"ready event bound {bound}")
        rss_ready, split = rss_mb(pid), rss_breakdown(pid)
        img = image_bytes(rng, 224, 224, "JPEG")
        body, ctype = multipart({"question": HTTP_QUESTIONS[0]}, [("image", "x.jpg", img)])
        status, answer = http_request(ready["port"], "POST", "/predict", body,
                                      {"Content-Type": ctype})
        require(status == 200 and json.loads(answer)["success"], f"/predict: {status}")
        stages_proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--worker", "rss_stages",
             "--out", stages_out, "--tmp", tmp], cwd=REPO)
        samples, t0 = [], time.monotonic()
        while time.monotonic() - t0 < idle_s:
            samples.append(rss_mb(pid))
            time.sleep(1.0)
        require(stages_proc.wait(timeout=300) == 0, "the rss_stages worker failed")
    finally:
        if stages_proc is not None and stages_proc.poll() is None:
            stages_proc.kill()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    with open(stages_out) as f:
        stages = json.load(f)
    kinds = [e["supervisor"] for e in events]
    spawned = [e["pid"] for e in events if e["supervisor"] == "spawn"]
    time.sleep(0.5)
    left = [p for p in spawned if proc_alive(p)]
    log(f"phase 15 (g): default-flag supervisor (bound {bound:.0f} MB), worker {pid} ready at "
        f"{rss_ready:.1f} MB RSS; idle {idle_s:.0f} s after one request: RSS {min(samples):.1f}-"
        f"{max(samples):.1f} MB; events {kinds}; exit {rc}; workers left {left}")
    log("phase 15 (g): worker RSS at ready by mapping, MB: "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items() if k != "files"))
    for name, st in stages.items():
        log(f"phase 15 (g): a bf16 engine built step by step, after {name}: RSS "
            f"{st['rss_mb']:.1f} MB (pinned host allocator {st['pinned']}); "
            + ", ".join(f"{k} {v:.1f}" for k, v in st["split"].items() if k != "files"))
    log(f"phase 15 (g): files of at least 20 MB in the ready worker's RSS, MB: "
        + ", ".join(f"{k} {v:.1f}" for k, v in split["files"].items()))
    require("recycle_start" not in kinds, f"the default bound recycled an idle worker: {kinds}")
    require(max(samples) < bound, f"worker RSS {max(samples):.1f} MB over the bound {bound}")
    require(rc == 0 and not left, f"supervisor exit {rc}, workers left {left}")
    return dict(bound_mb=bound, rss_mb_ready=rss_ready, rss_mb_idle_max=max(samples),
                rss_split_ready=split, events=kinds, exit_code=rc, stages=stages)


def drive_graphs(torch, rng, multi_device: dict, tmp: str) -> dict:
    """Phase 15: (a)-(d) on a full-width f32 and a bf16 engine, (e) phase
    13 (c)'s two graphed replicas, (f) the roofline floor, (g) the default
    supervisor; each part's seconds logged."""
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import ModelConfig

    t_start = time.perf_counter()
    out, timing = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        t0 = time.perf_counter()
        engine = VQAInference(model_config=ModelConfig(), device="cuda", dtype=dtype).load()
        load_s = time.perf_counter() - t0
        # bf16: phase 11 (b)'s rule, twice the bucket spread and at least 1e-4
        tol = GRAPH_TOL if name == "f32" else max(GRAPH_TOL, 2 * max(
            bucket_spread(engine, rng).values()))
        out[name] = dict(load_and_capture_s=load_s, tol=tol,
                         replay_vs_eager=graphs_match_eager(engine, rng, tol),
                         alias_err=chunks_do_not_alias(engine, rng),
                         launches_per_replay=launches_per_replay(torch, engine))
        timing[name] = eager_vs_graph(torch, engine, rng)
        log(f"phase 15 ({name}): load with capture {load_s:.1f} s; (a)-(d) "
            f"{time.perf_counter() - t0:.1f} s")
        del engine
        torch.cuda.empty_cache()
    out["timing"] = timing
    replicas = multi_device["replicas"]
    require(replicas.get("graphs_per_bucket") == 2, "phase 13 (c)'s replicas were not graphed")
    out["replicas"] = {k: replicas[k] for k in ("err_n1", f"err_n{BUCKET}")}
    log(f"phase 15 (e): phase 13 (c)'s two replicas on cuda:0, each replaying its own graphs, "
        f"against one: max err {out['replicas']} (tol {REPLICA_TOL})")
    out["roofline"] = roofline_floor(timing)
    t0 = time.perf_counter()
    out["supervisor"] = default_supervisor_idle(rng, tmp)
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 15: (g) {time.perf_counter() - t0:.1f} s; {out['seconds']:.1f} s in all")
    return out


# ---- phase 16: the trainer's and the evaluator's CUDA graphs, the ablation runner
#
# On the card every Trainer step, device augmentation and validation forward,
# and every evaluation forward, is the replay of one CUDA graph per batch
# shape (training/step_graph.py); the eager step stays as the yardstick.
# (a) holds the graph to the eager step from the same state with
# deterministic cuDNN, so that what differs is the graph alone.

GRAPH_STEPS = 5           # (a): two eager warm steps, the capture's replay, two more replays
GRAPH_BATCH = 32
GRAPH_CASES = {           # (a): name → (model dtype, grad_accum, remat)
    "f32": ("f32", 1, "none"), "bf16": ("bf16", 1, "none"), "f32_accum2": ("f32", 2, "none"),
    "f32_remat_stages": ("f32", 1, "stages"), "f32_remat_full": ("f32", 1, "full")}
STEP_TIMING_STEPS = {32: 10, 256: 6}  # (b): steps per side and round
PIPELINE_BATCHES = 6      # (b): batches timed through prefetch_to_device
VAL_GRAPH_BATCH = 32      # (c): four validation batches of the 640-sample synthetic split
ABLATION_ARGV = ("--epochs", "1", "--num-images", "300", "--val-num-images", "100",
                 "--seeds", "42")  # (e): the JAX script's corpora cut from 2,500/500 scenes


def train_runs(torch, cfg, device, batches, dtype=None, graphed=False, grad_accum=1,
               remat="none", mesh=None, lr=1e-4, seed=16) -> dict:
    """``len(batches)`` train steps from seeded weights and a seeded dropout
    generator, with deterministic cuDNN, through the eager step or
    ``GraphedTrainStep``: the model, its TrainState and step, the loss of
    each step and the card's generator state before each step."""
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.models.vqa_model import shard_model
    from vqa_tpu_torch.training.step_graph import GraphedTrainStep
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig

    model = create_vqa_model(config=cfg, device=device, seed=seed,
                             dtype=dtype or torch.float32)
    if mesh is not None:
        shard_model(model, mesh)
    state = TrainState.create(
        model, TrainingConfig(learning_rate=lr, warmup_epochs=0, num_epochs=3), 10)
    step = make_train_step(model, grad_accum=grad_accum, remat=remat)
    if graphed:
        step = GraphedTrainStep(step, state)
    torch.manual_seed(21)
    losses, rng = [], []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
        for b in batches:
            rng.append(torch.cuda.get_rng_state(device))
            losses.append(float(step(state, *b)["loss"]))
    return dict(model=model, state=state, step=step, losses=losses, rng=rng)


def _grad_norm(model) -> float:
    return math.sqrt(sum(float((p.grad.double() ** 2).sum())
                         for p in model.parameters() if p.grad is not None))


def compare_runs(torch, got, want) -> dict:
    """Largest differences of ``got`` from ``want`` (runs of ``train_runs``):
    per-step losses, the clipped gradients' norm after the last step,
    parameters, clipped gradients and BN's running statistics."""
    a, b = got["model"], want["model"]
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
    bn = [k for k in bb if k.endswith(("running_mean", "running_var"))]
    return dict(
        loss=max(abs(x - y) for x, y in zip(got["losses"], want["losses"])),
        grad_norm=abs(_grad_norm(a) - _grad_norm(b)),
        param=max(_max_diff(pa[n], p) for n, p in pb.items()),
        grad=max(_max_diff(pa[n].grad, p.grad) for n, p in pb.items() if p.grad is not None),
        bn=max(_max_diff(ba[k], bb[k]) for k in bn),
        rng_equal=all(torch.equal(x, y) for x, y in zip(got["rng"], want["rng"])))


def graph_batches(torch, cfg, device, batch: int = GRAPH_BATCH, steps: int = GRAPH_STEPS):
    return [[torch.from_numpy(a).to(device) for a in synthetic_batch(cfg, batch, seed=30 + i)]
            for i in range(steps)]


def fresh_masks(torch, run, batch) -> dict:
    """Two replays of a graphed run on one batch with the learning rate at 0
    (the weights stay; BN's running statistics do not enter a training
    forward): their losses differ only if the dropout masks do."""
    state = run["state"]
    state.schedule = lambda step: 0.0
    before = [p.detach().clone() for p in run["model"].parameters()]
    replays = run["step"].calls.replays
    losses = [float(run["step"](state, *batch)["loss"]) for _ in range(2)]
    moved = max(_max_diff(p, q) for p, q in zip(run["model"].parameters(), before))
    require(run["step"].calls.replays == replays + 2, "the two steps were not replays")
    require(moved == 0.0, f"weights moved by {moved:.3e} at learning rate 0")
    require(losses[0] != losses[1], f"two replays drew the same dropout masks: {losses}")
    return dict(losses=losses)


def graph_vs_eager(torch, cfg, device) -> dict:
    """(a) Each of GRAPH_CASES, eagerly and graphed, from the same weights,
    batches and dropout generator: every case within REMAT_TOL (the same
    kernels on the same state, so bf16 too), and bf16 also within
    ``compare_bf16_steps``'s bound (its f32 runs the f32 case's); the
    graphed run's generator state before each step equal to the eager
    run's; then two replays at learning rate 0 draw other masks."""
    from vqa_tpu_torch.utils.graphs import WARM_FORWARDS

    batches = graph_batches(torch, cfg, device)
    out, runs = {}, {}
    for name, (dtype, accum, remat) in GRAPH_CASES.items():
        kw = dict(dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                  grad_accum=accum, remat=remat)
        t0 = time.perf_counter()
        eager = train_runs(torch, cfg, device, batches, **kw)
        graph = train_runs(torch, cfg, device, batches, graphed=True, **kw)
        calls = graph["step"].calls
        require((calls.eager_calls, calls.replays) == (WARM_FORWARDS, GRAPH_STEPS - WARM_FORWARDS),
                f"{name}: {calls.eager_calls} eager steps, {calls.replays} replays")
        r = compare_runs(torch, graph, eager)
        r["seconds"] = time.perf_counter() - t0
        require(r["rng_equal"], f"{name}: the graphed run's generator states differ")
        for k in ("loss", "grad_norm", "param", "grad", "bn"):
            require(r[k] <= REMAT_TOL, f"{name}: graph vs eager {k} off by {r[k]:.3e}")
        log(f"phase 16 (a) {name}: {GRAPH_STEPS} steps at B={GRAPH_BATCH} ({WARM_FORWARDS} "
            f"eager, then the capture's replay and {GRAPH_STEPS - WARM_FORWARDS - 1} more), "
            f"graph vs eager: loss {r['loss']:.3e}, clipped-gradient norm {r['grad_norm']:.3e}, "
            f"parameters {r['param']:.3e}, gradients {r['grad']:.3e}, BN {r['bn']:.3e} "
            f"(tol {REMAT_TOL}); losses {[round(x, 6) for x in graph['losses']]}; {r['seconds']:.1f} s")
        out[name] = r
        if name in ("f32", "bf16"):
            runs[name] = (eager, graph)
        else:
            del eager, graph
    (e32, g32), (e16, g16) = runs["f32"], runs["bf16"]
    b = compare_bf16_steps(torch, {k: (run["model"], {"loss": run["losses"][-1]}) for k, run in (
        ("cpu32", e32), ("cpu16", e16), ("card32", g32), ("card16", g16))}, lr=1e-4)
    log(f"phase 16 (a) bf16 graph vs eager by compare_bf16_steps (eager f32/bf16 in the CPU's "
        f"place): loss err {b['loss_err']:.3e} (noise {b['loss_noise']:.3e}); gradient tensors "
        f"past the bound {b['grad']['n_past_bound']}, BN {b['bn']['n_past_bound']}; params "
        f"{b['param_err']:.3e}")
    require(not b["failures"], "bf16 graph vs eager: " + "; ".join(b["failures"][:5]))
    out["bf16"]["bound"] = {k: b[k] for k in ("loss_err", "loss_noise", "param_err")}
    out["fresh_masks"] = fresh_masks(torch, g32, batches[0])
    log(f"phase 16 (a): two f32 replays on one batch at learning rate 0: losses "
        f"{out['fresh_masks']['losses']} (fresh dropout masks per replay)")
    del runs, e32, g32, e16, g16
    torch.cuda.empty_cache()
    return out


def mesh_graph_equals_plain(torch, cfg, device, mesh) -> dict:
    """(a) GRAPH_STEPS f32 steps through ``GraphedTrainStep`` on the NCCL
    world-of-one mesh (the gradient all_reduce inside the graph) against
    the plain eager steps, deterministic cuDNN: every tensor within the
    plain run's own run-to-run difference."""
    batches = graph_batches(torch, cfg, device)
    plain = train_runs(torch, cfg, device, batches)
    again = train_runs(torch, cfg, device, batches)
    graph = train_runs(torch, cfg, device, batches, graphed=True, mesh=mesh)
    got, noise = compare_runs(torch, graph, plain), compare_runs(torch, again, plain)
    past = [k for k in ("loss", "param", "grad", "bn") if got[k] > noise[k]]
    log(f"phase 16 (a): {GRAPH_STEPS} f32 steps graphed on the NCCL world-of-one mesh vs "
        f"plain: {', '.join(f'{k} {got[k]:.3e}' for k in ('loss', 'param', 'grad', 'bn'))} "
        f"(run-to-run {', '.join(f'{k} {noise[k]:.3e}' for k in ('loss', 'param', 'grad', 'bn'))}"
        f"); replays {graph['step'].calls.replays}")
    require(not past, f"graphed mesh step vs plain: {past} past the run-to-run difference")
    return dict(diff={k: got[k] for k in ("loss", "param", "grad", "bn")},
                noise={k: noise[k] for k in ("loss", "param", "grad", "bn")},
                replays=graph["step"].calls.replays)


def _spread(values) -> dict:
    return dict(median=statistics.median(values), min=min(values), max=max(values))


def step_timing(torch, cfg, device, batch: int, dtype, rounds: int = TIMING_ROUNDS) -> dict:
    """(b) One model and TrainState stepped by the eager step and by its
    graph in turns (the order flipped each round): ms per step (CUDA events
    over STEP_TIMING_STEPS[batch] steps), host ms per step (the dispatch
    loop's wall time before the sync), train pairs/s; the card's busy ms
    per step from a profiled window of 5 steps per side, and its share of
    the median ms per step (a window's own wall time would count the
    profiler's start); peak memory of the eager warm steps and of the
    capture, and the graph pool's size."""
    from torch.profiler import ProfilerActivity, profile

    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.step_graph import GraphedTrainStep
    from vqa_tpu_torch.training.train import TrainState, make_train_step
    from vqa_tpu_torch.utils.config import TrainingConfig
    from vqa_tpu_torch.utils.graphs import WARM_FORWARDS

    rng = np.random.default_rng(batch)
    size, L = cfg.image_size, cfg.max_question_length
    args = [torch.from_numpy(a).to(device) for a in (
        rng.standard_normal((batch, size, size, 3)).astype(np.float32),
        rng.integers(4, cfg.vocab_size, (batch, L)).astype(np.int32),
        np.ones((batch, L), np.int32),
        rng.integers(0, cfg.num_answers, batch).astype(np.int32))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    model = create_vqa_model(config=cfg, device=device, seed=13, dtype=dtype)
    state = TrainState.create(model, TrainingConfig(warmup_epochs=0), 100)
    sides = {"eager": make_train_step(model)}
    sides["graph"] = GraphedTrainStep(sides["eager"], state)
    for _ in range(WARM_FORWARDS):  # the graph's warm steps run the eager step
        sides["graph"](state, *args)
    torch.cuda.synchronize(device)
    eager_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    sides["graph"](state, *args)  # the capture and its replay
    torch.cuda.synchronize(device)
    graph_peak = torch.cuda.max_memory_allocated(device)
    pool = torch.cuda.memory_reserved(device) - reserved
    n = STEP_TIMING_STEPS[batch]
    per = {k: {"step_ms": [], "host_ms": []} for k in sides}
    for r in range(rounds):
        for name in (("eager", "graph") if r % 2 == 0 else ("graph", "eager")):
            fn = sides[name]
            fn(state, *args)
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                m = fn(state, *args)
            host_ms = (time.perf_counter() - t0) * 1e3 / n
            end.record()
            end.synchronize()
            per[name]["step_ms"].append(start.elapsed_time(end) / n)
            per[name]["host_ms"].append(host_ms)
    require(math.isfinite(float(m["loss"])), "non-finite loss in the timed steps")
    out = dict(batch=batch, dtype=str(dtype).replace("torch.", ""), steps_per_round=n,
               rounds=rounds, eager_peak_bytes=eager_peak, capture_peak_bytes=graph_peak,
               graph_pool_bytes=pool)
    window = 5
    for name, fn in sides.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                fn(state, *args)
            torch.cuda.synchronize(device)
        busy_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / window
        step = _spread(per[name]["step_ms"])
        out[name] = dict(step_ms=step, host_ms=_spread(per[name]["host_ms"]),
                         pairs_per_s=batch / step["median"] * 1e3,
                         device_busy_ms_per_step=busy_ms,
                         device_busy_share=busy_ms / step["median"],
                         step_ms_rounds=per[name]["step_ms"], host_ms_rounds=per[name]["host_ms"])
    require(sides["graph"].calls.replays > rounds * n, "the graph side did not replay")
    e, g = out["eager"], out["graph"]
    log(f"phase 16 (b) {out['dtype']} B={batch}, eager / graph, median of {rounds} rounds "
        f"[min, max]: ms per step {e['step_ms']['median']:.3f} [{e['step_ms']['min']:.3f}, "
        f"{e['step_ms']['max']:.3f}] / {g['step_ms']['median']:.3f} [{g['step_ms']['min']:.3f}, "
        f"{g['step_ms']['max']:.3f}]; host ms per step {e['host_ms']['median']:.3f} / "
        f"{g['host_ms']['median']:.3f}; pairs/s {e['pairs_per_s']:.1f} / {g['pairs_per_s']:.1f}; "
        f"card busy {e['device_busy_ms_per_step']:.3f} / {g['device_busy_ms_per_step']:.3f} ms "
        f"per step, {100 * e['device_busy_share']:.1f}% / {100 * g['device_busy_share']:.1f}%; "
        f"peak memory eager {eager_peak / 2**30:.2f} GiB, capture {graph_peak / 2**30:.2f} GiB, "
        f"graph pool {pool / 2**30:.2f} GiB")
    del model, state, sides, args
    torch.cuda.empty_cache()
    return out


def pipeline_host_ms(torch, device, batch: int, batches: int = PIPELINE_BATCHES,
                     image_size: int = 224) -> dict:
    """(b) Host ms per batch of ``prefetch_to_device`` over the synthetic
    train loader as the 12-epoch run builds it (uint8 scenes for device
    augmentation, 4 decode threads), with nothing else running: the time
    between yielded batches after the first."""
    from vqa_tpu_torch.data.pipeline import prefetch_to_device
    from vqa_tpu_torch.data.synthetic import create_synthetic_loaders

    samples = math.ceil((batches + 1) * batch / 0.8) + 1
    loader, _, _, _ = create_synthetic_loaders(
        num_samples=samples, batch_size=batch, eval_batch_size=batch, image_size=image_size,
        max_question_length=20, device_augment=True, seed=5, num_workers=4)
    it = prefetch_to_device(loader, device)
    next(it)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    log(f"phase 16 (b): data pipeline at B={batch}: {ms:.3f} host ms per batch over {n} "
        f"batches (synthetic scenes, uint8, 4 threads, prefetch_to_device)")
    return dict(batch=batch, batches=n, host_ms_per_batch=ms)


def trainer_graphs(torch, device) -> dict:
    """(c) A full-width bf16 Trainer on the synthetic split: the augment
    graph bit-equal to the eager augmentation from the same seeds; the
    validation graph, captured after epoch 0, after epoch 1 equal to the
    eager validation of epoch 1's weights, launching the bf16 forms 1, 4
    and 2 times per replayed forward; the evaluator's graphed top-1 equal
    to the trainer's."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_augment
    from vqa_tpu_torch.data.synthetic import create_synthetic_loaders
    from vqa_tpu_torch.models import create_vqa_model
    from vqa_tpu_torch.training.evaluate import Evaluator
    from vqa_tpu_torch.training.train import Trainer, _augment_seed, make_val_step
    from vqa_tpu_torch.utils.config import ModelConfig, TrainingConfig
    from vqa_tpu_torch.utils.graphs import WARM_FORWARDS

    base = ModelConfig()
    size = base.image_size
    train_loader, val_loader, tok, vocab = create_synthetic_loaders(
        num_samples=640, batch_size=64, eval_batch_size=VAL_GRAPH_BATCH, image_size=size,
        max_question_length=base.max_question_length, device_augment=True, seed=3,
        num_workers=4)
    cfg = ModelConfig(vocab_size=tok.vocab_size, num_answers=vocab.num_answers)
    model = create_vqa_model(config=cfg, device=device, seed=17, dtype=torch.bfloat16)
    trainer = Trainer(model, train_loader, val_loader, config=TrainingConfig(
        num_epochs=2, warmup_epochs=0), save_checkpoints=False, seed=3)
    pixels = torch.from_numpy(next(iter(train_loader))["image"]).to(device)
    equal = []
    for step in range(WARM_FORWARDS + 3):
        got = trainer.augment(pixels, 0, step)
        gen = torch.Generator(device=device).manual_seed(_augment_seed(trainer.seed, 0, step))
        equal.append(bool(torch.equal(got, device_augment(pixels, gen, image_size=size))))
    aug_replays = trainer._augment.replays
    require(all(equal) and aug_replays == 3,
            f"augment graph vs eager: bit-equal {equal}, {aug_replays} replays")
    trainer.train_epoch(0)
    first = trainer.validate()
    trainer.train_epoch(1)
    ops.reset_launch_counts()
    replays = trainer.val_step.replays
    graphed = trainer.validate()
    launches = ops.launch_counts()
    forwards = len(val_loader)
    require(trainer.val_step.replays - replays == forwards, "validation forwards not replayed")
    for name, per in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(launches[name + "_bf16"] == per * forwards and launches[name] == 0,
                f"validation graph launches {launches} in {forwards} replays")
    with mock.patch.object(trainer, "val_step", make_val_step(
            model, num_types=len(trainer.val_type_vocab or ()))):
        eager = trainer.validate()
    loss_err = abs(graphed["val_loss"] - eager["val_loss"])
    log(f"phase 16 (c): augment graph bit-equal to eager over {len(equal)} seeds "
        f"({aug_replays} replays); validation after epoch 1 (the graph captured "
        f"after epoch 0): graph loss {graphed['val_loss']:.7f} top-1 {graphed['val_top1']:.4f}, "
        f"eager {eager['val_loss']:.7f} / {eager['val_top1']:.4f} (epoch 0: "
        f"{first['val_loss']:.7f}); launches over {forwards} replays {launches}")
    require(loss_err <= 1e-6 * max(1.0, abs(eager["val_loss"]))
            and graphed["val_top1"] == eager["val_top1"]
            and graphed["val_top5"] == eager["val_top5"],
            f"validation graph vs eager: loss off by {loss_err:.3e}")
    require(graphed["val_loss"] != first["val_loss"], "validation did not see epoch 1's weights")
    ev = Evaluator(model)
    res = ev.evaluate(val_loader)
    log(f"phase 16 (c): evaluator top-1 {res['top1_accuracy']:.4f} over {res['num_samples']} "
        f"samples ({ev._eval_step.replays} graph replays), the trainer's {graphed['val_top1']:.4f}")
    require(res["top1_accuracy"] == graphed["val_top1"] and ev._eval_step.replays > 0,
            "the evaluator's graphed top-1 differs from the trainer's")
    out = dict(augment_bit_equal=len(equal), val_loss_graph=graphed["val_loss"],
               val_loss_eager=eager["val_loss"], val_loss_err=loss_err,
               val_top1=graphed["val_top1"], val_launches=launches, val_forwards=forwards,
               evaluator_top1=res["top1_accuracy"], evaluator_replays=ev._eval_step.replays)
    del trainer, model, ev
    torch.cuda.empty_cache()
    return out


def ablation_on_card(torch, tmp: str, extra=()) -> dict:
    """(e) ``tools/run_ablation.py`` cut (ABLATION_ARGV): corpora, then three
    variants trained and evaluated in subprocesses on the card, the table
    written; then the same call again, which must run nothing. ``extra``
    flags go to the runner (``--device cpu`` rehearses it, with the runner's
    ``sh`` wrapped to give the train commands ``--tiny``)."""
    from vqa_tpu_torch.tools import run_ablation

    out_path, log_path = os.path.join(tmp, "ABLATION.json"), os.path.join(tmp, "ablation.log")
    argv = [*ABLATION_ARGV, "--train-corpus", os.path.join(tmp, "train"),
            "--val-corpus", os.path.join(tmp, "val"), "--checkpoint-root",
            os.path.join(tmp, "checkpoints"), "--out", out_path, "--log", log_path, *extra]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        run_ablation.main(argv)
    except SystemExit:
        with open(log_path, errors="replace") as f:
            log("ablation log, last lines:\n" + "".join(f.readlines()[-40:]))
        raise
    first_s = time.perf_counter() - t0
    with open(out_path) as f:
        table = json.load(f)
    with open(log_path, errors="replace") as f:
        graphed = f.read().count("train steps and device augmentation: one CUDA graph per")
    calls = []
    t0 = time.perf_counter()
    with mock.patch.object(run_ablation, "sh", lambda cmd, log=None: calls.append(cmd)):
        run_ablation.main(argv)
    rerun_s = time.perf_counter() - t0
    variants = table["variants"]
    require(set(variants) == {"full", "no_spatial", "no_attention"}
            and all(v["n_seeds"] == 1 for v in variants.values()),
            f"ablation table: {sorted(variants)}")
    require(graphed == 3, f"{graphed} of the 3 training runs logged CUDA graphs")
    require(not calls, f"the rerun ran {len(calls)} subprocesses")
    for name, v in variants.items():
        cell = v["per_seed"]["42"]
        log(f"phase 16 (e): {name}: held-out top-1 {cell['heldout_top1']:.4f}, top-5 "
            f"{cell['heldout_top5']:.4f}, soft {cell['vqa_soft_accuracy']:.4f} on "
            f"{cell['num_samples']} questions, trained in {cell['train_wall_s']:.1f} s; per type "
            + ", ".join(f"{k} {a:.3f}" for k, a in sorted(cell["per_type_accuracy"].items())))
    log(f"phase 16 (e): the cut ablation in {first_s:.1f} s, its rerun in {rerun_s:.1f} s "
        f"(nothing rerun)")
    return dict(seconds=first_s, rerun_seconds=rerun_s, argv=list(ABLATION_ARGV),
                heldout_top1={k: v["mean_heldout_top1"] for k, v in variants.items()},
                table=table)


def drive_train_graphs(torch, tmp: str, bf16_training: dict, multi_device: dict,
                       device=None, extra=()) -> dict:
    """Phase 16 at full width (``ModelConfig()``): (a) graph vs eager steps
    and phase 13 (a)'s graphed NCCL world-of-one step, (b) paired timing and
    the data pipeline, (c) augmentation, validation and evaluator graphs,
    (d) phase 12 (b)'s 12-epoch run through the graphs, (e) the ablation
    runner (``extra`` its flags); each part's seconds logged."""
    from vqa_tpu_torch.utils.config import ModelConfig
    from vqa_tpu_torch.utils.graphs import WARM_FORWARDS

    device = device or torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig()
    out, seconds = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t
        log(f"phase 16 ({name}): {seconds[name]:.1f} s")
        return result

    out["graph_vs_eager"] = part("a", lambda: graph_vs_eager(torch, cfg, device))
    out["nccl_world_one"] = multi_device["nccl_world_one"]["graph_step"]
    out["timing"] = part("b", lambda: {
        f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_{b}": step_timing(torch, cfg, device,
                                                                            b, dtype)
        for dtype in (torch.bfloat16, torch.float32) for b in TRAIN_BATCH_SIZES})
    out["pipeline"] = {str(b): pipeline_host_ms(torch, device, b, image_size=cfg.image_size)
                       for b in TRAIN_BATCH_SIZES}
    out["trainer_graphs"] = part("c", lambda: trainer_graphs(torch, device))
    syn = bf16_training["synthetic"]
    steps = sum(e["train_steps"] for e in syn["epochs"])
    replays = sum(e["train_replays"] for e in syn["epochs"])
    val_replays = sum(e["val_replays"] for e in syn["epochs"])
    forwards = sum(e["val_forwards"] for e in syn["epochs"])
    log(f"phase 16 (d): phase 12 (b)'s 12-epoch bf16 run through the graphs: {replays} of "
        f"{steps} train steps and {val_replays} of {forwards} validation forwards replayed; "
        f"seconds per epoch {[round(e['train_s'] + e['val_s'], 1) for e in syn['epochs']]}; best "
        f"val top-1 {syn['best_val_top1']:.4f} (at least {SYNTHETIC_MIN_TOP1})")
    require(replays == steps - WARM_FORWARDS and val_replays == forwards - WARM_FORWARDS,
            "the 12-epoch run did not go through the graphs")
    out["synthetic"] = dict(train_replays=replays, train_steps=steps, val_replays=val_replays,
                            val_forwards=forwards, best_val_top1=syn["best_val_top1"],
                            epoch_seconds=[e["train_s"] + e["val_s"] for e in syn["epochs"]])
    out["ablation"] = part("e", lambda: ablation_on_card(torch, tmp, extra))
    out["phase_seconds"] = seconds
    log("phase 16: " + ", ".join(f"({k}) {v:.1f} s" for k, v in seconds.items()))
    return out


# ---- phase 17: the JAX trainer's Orbax checkpoint ---------------------------

ORBAX_FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_narrow")
ORBAX_F32_TOL = 1e-4  # the f32 engine's probabilities against the JAX engine's


def _orbax_fixture_inputs():
    """``tests/fixtures/orbax_narrow/inputs.py`` (numpy only), by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "orbax_fixture_inputs", os.path.join(ORBAX_FIXTURE, "inputs.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _leaf_digests(tree, path=()) -> dict:
    """{dotted key path: SHA-256} of every array leaf, as ``expected.npz``
    names them."""
    import hashlib

    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaf_digests(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _leaf_digests(x, path + (str(i),)).items()}
    if tree is None or isinstance(tree, (int, float)):
        return {}
    return {".".join(path): hashlib.sha256(np.ascontiguousarray(tree).tobytes()).hexdigest()}


def orbax_decode() -> dict:
    """(a) Build the decoder, time it over the fixture's chunks (one
    thread, the pool) and the whole read (``tools/checkpoint_read.py``),
    and hold every array to its digest."""
    from vqa_tpu_torch import native
    from vqa_tpu_torch.native import zstd
    from vqa_tpu_torch.tools import checkpoint_read
    from vqa_tpu_torch.training.checkpoint import load_orbax_checkpoint

    t0 = time.perf_counter()
    native.compile_library(zstd.SOURCE, zstd.LIBRARY)
    zstd.load()
    build_s = time.perf_counter() - t0
    out = checkpoint_read.measure(ORBAX_FIXTURE, "best_model")
    tree, cfg, _ = load_orbax_checkpoint(ORBAX_FIXTURE, "best_model")
    expected = np.load(os.path.join(ORBAX_FIXTURE, "expected.npz"))
    want = dict(zip(expected["names"].astype(str), expected["sha256"].astype(str)))
    got = _leaf_digests(tree)
    require(got == want, f"phase 17 (a): {sum(got.get(k) != v for k, v in want.items())} of "
            f"{len(want)} arrays differ from their digests")
    out.update(build_s=build_s, step=int(tree["step"]), image_size=cfg.image_size)
    log(f"phase 17 (a): zstd decoder built in {build_s:.1f} s; {out['chunks']} chunks, "
        f"{out['chunk_mb']:.3f} MB decoded: one thread {out['one_thread']['mb_per_s']:.1f} "
        f"MB/s, the pool {out['pool']['mb_per_s']:.1f} MB/s over {out['pool']['copies']} copies; "
        f"the whole checkpoint read in {out['read_ms']:.2f} ms (median of 5), "
        f"{len(got)} arrays equal to their digests")
    return out


def orbax_engines(torch, device="cuda") -> tuple:
    """(b) The engine loaded from the fixture in f32 and bf16, its answers
    held to ``expected.npz``; returns (results, launches per form)."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.data.preprocess import device_normalize
    from vqa_tpu_torch.ops import cross_attention_kernel, se_kernel, stem_kernel
    from vqa_tpu_torch.serving.engine import VQAInference

    inputs = _orbax_fixture_inputs()
    expected = np.load(os.path.join(ORBAX_FIXTURE, "expected.npz"))
    want = expected["probs"]
    pixels, questions = inputs.images(), list(inputs.QUESTIONS)
    require(tuple(expected["questions"].astype(str)) == inputs.QUESTIONS,
            "phase 17: expected.npz holds other questions than inputs.py")
    out, launches = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = VQAInference(checkpoint_dir=ORBAX_FIXTURE, device=device, dtype=dtype).load()
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        require(engine.model_loaded_from_checkpoint, f"phase 17 (b): {name} engine not loaded")
        form = "_bf16" if name == "bf16" else ""
        ops.reset_launch_counts()
        probs = engine.predict_probs_from_pixels(pixels, questions)
        counts = ops.launch_counts()
        forwards = -(-len(questions) // engine._bucket(len(questions)))
        for kernel, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
            other = "" if form else "_bf16"
            require(counts[kernel + form] == per_forward * forwards
                    and counts[kernel + other] == 0,
                    f"phase 17 (b): {name} launches {counts} in {forwards} forwards")
        launches.update({k: v for k, v in counts.items() if k.endswith("_bf16") == bool(form)})
        require(bool(np.isfinite(probs).all()), f"phase 17 (b): non-finite {name} answers")
        err = float(np.abs(probs - want).max())
        res = dict(load_ms=load_ms, max_abs_err_vs_jax=err, forwards=forwards,
                   argmax_equal=bool((probs.argmax(-1) == want.argmax(-1)).all()))
        if name == "f32":
            require(err <= ORBAX_F32_TOL, f"phase 17 (b): f32 answers {err:.3e} from JAX's "
                    f"(tol {ORBAX_F32_TOL:.0e})")
            f32_engine, f32_probs = engine, probs
        else:
            # phase 11 (b)'s bound: the kernels no further from the plain
            # bf16 forward than that is from f32
            ids, mask = engine.tokenizer.encode_batch_np(questions)
            x = torch.from_numpy(pixels).to(engine.device)
            ids = torch.from_numpy(ids).long().to(engine.device)
            mask = torch.from_numpy(mask).to(engine.device)
            with torch.inference_mode(), \
                    mock.patch.object(stem_kernel, "fused_stem", stem_kernel.plain_stem), \
                    mock.patch.object(se_kernel, "fused_se", se_kernel.plain_se), \
                    mock.patch.object(cross_attention_kernel, "fused_cross_attention",
                                      cross_attention_kernel.plain_cross_attention):
                logits, _ = engine.model(device_normalize(x), ids, mask)
                plain = torch.softmax(logits.float(), dim=-1).cpu().numpy()
            noise = float(np.abs(plain - f32_probs).max())
            kernel_err = float(np.abs(probs - plain).max())
            top2 = np.sort(f32_probs, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * noise
            agree = bool((probs.argmax(-1) == f32_probs.argmax(-1))[clear].all())
            res.update(kernels_vs_plain=kernel_err, plain_vs_f32=noise,
                       rows_compared=int(clear.sum()), argmax_agrees=agree)
            require(kernel_err <= noise, f"phase 17 (b): bf16 kernels {kernel_err:.3e} from "
                    f"the plain bf16 forward, over bf16's own noise {noise:.3e}")
            require(agree, "phase 17 (b): bf16 argmax differs from f32 on a clear row")
        out[name] = res
        log(f"phase 17 (b): {name} engine from the Orbax fixture: load {load_ms:.1f} ms "
            f"(graphs captured), answers vs the JAX engine's f32 max err {err:.3e}"
            + (f", kernels vs plain bf16 {res['kernels_vs_plain']:.3e} within bf16's own "
               f"{res['plain_vs_f32']:.3e}" if name == "bf16" else "")
            + f"; launches {counts}")
        if name == "bf16":
            del engine
    return out, launches, f32_engine, f32_probs


def orbax_export(torch, tmp: str, f32_probs, device="cuda") -> dict:
    """(c) The exporter CLI's ``.pth``, loaded by the f32 engine: the same
    answers."""
    import shutil

    from vqa_tpu_torch.serving.engine import VQAInference

    out_dir = os.path.join(tmp, "exported")
    os.makedirs(out_dir)
    for name in ("tokenizer.json", "answer_vocab.json"):
        shutil.copyfile(os.path.join(ORBAX_FIXTURE, name), os.path.join(out_dir, name))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.compat.torch_export", "--checkpoint-dir",
         ORBAX_FIXTURE, "--which", "best_model", "--out", os.path.join(out_dir, "model.pth")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    export_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"phase 17 (c): the exporter exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    engine = VQAInference(checkpoint_dir=out_dir, checkpoint_name="model.pth", device=device,
                          dtype=torch.float32).load()
    inputs = _orbax_fixture_inputs()
    probs = engine.predict_probs_from_pixels(inputs.images(), list(inputs.QUESTIONS))
    err = float(np.abs(probs - f32_probs).max())
    require(err <= 1e-6 and (probs.argmax(-1) == f32_probs.argmax(-1)).all(),
            f"phase 17 (c): the exported .pth answers {err:.3e} from the Orbax directory's "
            "engine")
    log(f"phase 17 (c): torch_export CLI {export_s:.1f} s; the engine on its .pth gives the "
        f"Orbax directory's answers (max err {err:.1e})")
    return dict(export_s=export_s, max_abs_err=err)


def orbax_evaluate(torch, tmp: str, extra=()) -> dict:
    """(d) The evaluator CLI on the fixture directory (demo data at the
    fixture's geometry), f32 on the card."""
    from vqa_tpu_torch import ops
    from vqa_tpu_torch.training import evaluate

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate.main(["--checkpoint-dir", ORBAX_FIXTURE, "--demo", "--max-samples", "64",
                         "--batch-size", "32", "--output-dir", os.path.join(tmp, "eval"),
                         *extra])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    forwards = -(-res["num_samples"] // 32)
    for name, per_forward in (("stem", 1), ("se", 4), ("cross_attention", 2)):
        require(counts[name] == per_forward * forwards,
                f"phase 17 (d): evaluator launches {counts} in {forwards} forwards")
    log(f"phase 17 (d): evaluate --demo on the Orbax fixture: {res['num_samples']} samples in "
        f"{wall:.1f} s, top-1 {res['top1_accuracy']:.4f}; launches {counts}")
    return dict(seconds=wall, samples=res["num_samples"], top1=res["top1_accuracy"],
                launches=counts)


def drive_orbax(torch, tmp: str, device="cuda", extra=()) -> tuple:
    """Phase 17; returns (summary, launches per kernel form over (b))."""
    t0 = time.perf_counter()
    out = {"decode": orbax_decode()}
    out["engines"], launches, engine, f32_probs = orbax_engines(torch, device)
    del engine
    out["export"] = orbax_export(torch, tmp, f32_probs, device)
    out["evaluate"] = orbax_evaluate(torch, tmp, extra)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {out['seconds']:.1f} s")
    return out, launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


WORKERS = {"nccl_world_one": worker_nccl_world_one, "gloo_two_ranks": worker_gloo_two_ranks,
           "nccl_one_card": worker_nccl_one_card, "rss_stages": worker_rss_stages}


def run_worker(args) -> int:
    """One rank of phase 13, or phase 15 (g)'s step-by-step engine
    (``--worker``): its result as JSON in ``--out``."""
    import torch

    sys.path.insert(0, REPO)
    from vqa_tpu_torch.parallel import distributed

    result = WORKERS[args.worker](torch, args)
    with open(args.out, "w") as f:
        json.dump(result, f)
    if not result.get("refused"):
        distributed.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="add a torch.profiler breakdown of the bucket-32 forward")
    p.add_argument("--seed", type=int, default=0)
    # one rank of phase 13 or phase 15 (g)'s engine, started by the script itself
    p.add_argument("--worker", choices=sorted(WORKERS), help=argparse.SUPPRESS)
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    for flag in ("--tmp", "--out"):
        p.add_argument(flag, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        return run_worker(args)
    t_start = time.perf_counter()
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
        f"{_build.load_library().vqa_stem_smem_bytes()} bytes (bf16 form "
        f"{_build.load_library().vqa_stem_bf16_smem_bytes()}), cross-attention "
        f"{smem_bytes(cfg.max_question_length, cfg.feature_spatial_size ** 2, cfg.embed_dim // cfg.num_attention_heads)}"
        f" bytes at the main path's shapes")

    rng = np.random.default_rng(args.seed)
    # phases 2-8 hold the engine to f32 tolerances, so they build it in f32
    # (the default on the card is bf16, phase 11); loading it on the card
    # also turns TF32 off
    engine = VQAInference(model_config=cfg, device="cuda", seed=args.seed,
                          dtype=torch.float32).load()
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train.") as tmp:
        training = drive_training(torch, rng, tmp)
        kernels16, bf16 = drive_bf16(torch, engine, tput, tmp, training["cli"]["val_top1"],
                                     rng, args.seed, args.profile)
    kernels.update(kernels16)
    del engine
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_train.") as tmp:
        bf16_training, val_launches = drive_bf16_training(torch, tmp, training["timing"])
    for name in kernels:  # f32 forms: 0, checked by synthetic_run
        kernels[name]["launches_bf16_training_validation"] = val_launches[name]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_device.") as tmp:
        multi_device = drive_multi_device(torch, tmp, bf16_training["timing"])
    replicas = multi_device["replicas"]
    for name in kernels:  # rank 0's mp2 forwards and dp2 evaluation, the replicas
        kernels[name]["launches_multi_device"] = (
            multi_device["gloo_two_ranks"]["launches"][name]
            + replicas["launches_n1"][name] + replicas[f"launches_n{BUCKET}"][name])
    t0 = time.perf_counter()
    tools, tool_launches = drive_tools(torch, rng)
    for name in kernels:  # (b)'s CBAMBlock calls, (c)'s eval forwards, (d)'s engine
        kernels[name]["launches_tools"] = tool_launches[name]
    log(f"phase 14: {time.perf_counter() - t0:.1f} s; chip_smoke so far "
        f"{time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs.") as tmp:
        graphs = drive_graphs(torch, rng, multi_device, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_graphs.") as tmp:
        train_graphs = drive_train_graphs(torch, tmp, bf16_training, multi_device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_orbax.") as tmp:
        orbax, orbax_launches = drive_orbax(torch, tmp)
    for name in kernels:  # (b)'s engines, each form in its own dtype
        kernels[name]["launches_orbax"] = orbax_launches.get(name, 0)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"engine": {
        "params": n_params, "build_s": build_s,
        "pairs_per_s_bucket1": tput[1]["pairs_per_s"],
        "pairs_per_s_bucket32": tput[BUCKET]["pairs_per_s"],
        "p50_ms_bucket1": tput[1]["p50_ms"], "p90_ms_bucket1": tput[1]["p90_ms"],
        "p50_ms_bucket32": tput[BUCKET]["p50_ms"],
        "p90_ms_bucket32": tput[BUCKET]["p90_ms"]}}))
    log(json.dumps({"serving": {**load, "http": http, "supervisor": supervisor}}))
    log(json.dumps({"training": training}))
    log(json.dumps({"bf16": bf16}))
    log(json.dumps({"bf16_training": bf16_training}))
    log(json.dumps({"multi_device": multi_device}))
    log(json.dumps({"tools": tools}))
    log(json.dumps({"graphs": graphs}))
    log(json.dumps({"train_graphs": train_graphs}))
    log(json.dumps({"orbax": orbax}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_bf16_training_validation", "launches_multi_device", "launches_tools",
            "launches_orbax", "stages")
    # the graphed forward's device ms per bucket-32 call (phase 15 (d)), beside
    # the kernels it runs
    log(json.dumps({"graphed_forward_device_ms_b32": {
        name: dict(median=t["graph"]["device_ms_b32"],
                   rounds=t["graph"]["rounds"]["device_ms_b32"])
        for name, t in graphs["timing"].items()}}))
    log(json.dumps({"kernels": [{k: ({"name": name, "stages": None, **r}[k]) for k in keys}
                                for name, r in kernels.items()]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
