"""Comparison and timing helpers of the port's on-card checks.

``chip_smoke.py``, the ``cuda`` tests (``tests/test_torch_cuda.py``) and
the kernel tools (``vqa_tpu_torch/tools``) take them from here, as
``numpy.testing`` and ``torch.testing`` serve their packages: device ms of
a call (``time_ms``), a bf16 output against its plain version in ulps
(``bf16_compare``), one train step on the card against the CPU's
(``one_train_step``, ``compare_train_steps``, ``compare_bf16_steps``),
graphed runs against eager ones (``train_runs``, ``compare_runs``,
``graphs_match_eager``), the attention modules on the card against the
CPU (``attention_modules_on_card``), and the JAX trainer's Orbax tree
written from a port model (``write_trainer_tree``).

At import it loads the standard library and numpy only: it imports without
a card, nvcc or jax. The helpers take ``torch`` as an argument and import
the port's modules inside, so a tool can load this file by path beside
another checkout's package (``tools/bf16_kernel_ab.py``). A failed check
raises ``AssertionError``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess

import numpy as np

BUCKET = 32
SE_STAGES = ((56, 64), (28, 128), (14, 256), (7, 512))  # (H = W, C) at 224 px
HTTP_QUESTIONS = ["what color is the cat", "how many dogs are there", "is this a man",
                  "what is the woman wearing", "what is on the table"]


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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
    raise RuntimeError("the profiler saw no device time in 3 windows")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def max_diff(a, b) -> float:
    """Largest |a - b| in f64, of tensors that may need grad; 0 where empty."""
    return float((a.detach().double() - b.detach().double()).abs().max()) if a.numel() else 0.0


# The bf16 stem's output is relu(conv * scale + bias), and where the affine
# nearly cancels the conv the value is ~1e-6: there the f32 sum's own error
# (each of the kernel and cuDNN's f32 conv within ~1e-6 of an f64
# reference on the H100) is more than a bf16 ulp of the value. So an
# element of the stem may also differ by the stem's f32 tolerance, 1e-5.
STEM_BF16_ATOL = 1e-5


def bf16_compare(torch, got, want, atol: float = 0.0, at=None) -> dict:
    """A bf16 output against its plain version, compared as f32, in units
    of the bf16 spacing at the larger magnitude of the two (and of ``at``,
    where given: an intermediate the function rounds to bf16 before its
    last step): the largest error, the elements beyond one ulp (and the
    largest |value| and error among them), and whether every element is
    within one ulp + ``atol``."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    if at is not None:
        mag = torch.maximum(mag, at.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 7)
    d = (g - w).abs()
    beyond = d > ulp
    n = int(beyond.sum())
    return dict(ulps=float((d / ulp).max()), beyond=n,
                beyond_max_value=float(mag[beyond].max()) if n else 0.0,
                beyond_max_err=float(d[beyond].max()) if n else 0.0,
                ok=bool((d <= ulp + atol).all()))


# The card-against-CPU train step (chip_smoke.py phase 10 (a) at full
# width, tests/test_torch_cuda.py at the tiny one; f32, TF32 off). At random
# initialisation many backbone gradients are ill-conditioned (BN's backward
# subtracts most of what reaches it): two correct f32 runs of the same step
# on the CPU, the batch in another order, differ by up to a sixth of some
# tensors' largest gradient. So the card is held to the CPU's own f32 noise, measured per
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


# The bf16 step (chip_smoke.py phase 12 (a)): the card's bf16 step against
# the CPU's bf16 step, both from the same weights and batch (dropout off).
# At random initialisation bf16 noise is large and lumpy: a ReLU unit whose
# input is near zero flips its mask in one rounding and not the other, which
# moves every gradient behind it by O(1). Each tensor is held, in L2, to the
# CPU's own bf16 noise alone (its bf16 step against its f32 step): twice
# that, plus a floor of the CPU's median relative noise times the tensor and
# phase 10 (a)'s floors. One tensor of each kind may pass that bound, within
# BF16_STEP_CAP times it, for a mask flip by chance (the card's readings:
# none past it, the nearest at 52% at full width and 74% at the cuda test's
# tiny width). What the card's rounding adds is held apart: its own median
# noise at most twice the CPU's. The loss: twice the CPU's own noise plus
# 2^-8 of it. Parameters: 2·lr (+1e-6), a first AdamW step being near
# lr·sign(g).
BF16_STEP_ALLOWED = {"grad": 1, "bn": 1}
BF16_STEP_CAP = 4.0


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
        param=max(max_diff(pa[n], p) for n, p in pb.items()),
        grad=max(max_diff(pa[n].grad, p.grad) for n, p in pb.items() if p.grad is not None),
        bn=max(max_diff(ba[k], bb[k]) for k in bn),
        rng_equal=all(torch.equal(x, y) for x, y in zip(got["rng"], want["rng"])))


def fresh_masks(torch, run, batch) -> dict:
    """Two replays of a graphed run on one batch with the learning rate at 0
    (the weights stay; BN's running statistics do not enter a training
    forward): their losses differ only if the dropout masks do."""
    state = run["state"]
    state.schedule = lambda step: 0.0
    before = [p.detach().clone() for p in run["model"].parameters()]
    replays = run["step"].calls.replays
    losses = [float(run["step"](state, *batch)["loss"]) for _ in range(2)]
    moved = max(max_diff(p, q) for p, q in zip(run["model"].parameters(), before))
    require(run["step"].calls.replays == replays + 2, "the two steps were not replays")
    require(moved == 0.0, f"weights moved by {moved:.3e} at learning rate 0")
    require(losses[0] != losses[1], f"two replays drew the same dropout masks: {losses}")
    return dict(losses=losses)


GRAPH_TOL = 1e-4      # f32 replay against the eager forward (tests/test_torch_engine.py:72)
ALIAS_ROWS = 70       # three chunks at bucket 32


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


def graphs_match_eager(engine, rng, tol: float) -> dict:
    """Phase 15 (a): every effective bucket of every replica is a graph,
    and at each bucket the replayed probabilities on inputs the capture
    never saw are within ``tol`` of the eager forward's
    (``_dispatch_eager``) on the same inputs. Returns the max abs err per
    bucket."""
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
    """Phase 15 (b): 70 requests through ``predict_probs_from_pixels``
    (three chunks, all dispatched before the first is fetched) against each
    chunk dispatched and fetched alone."""
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
    """Phase 15 (c): one dispatch at each effective bucket: the forms of the
    engine's dtype launched 1, 4 and 2 times per replayed forward, the
    others not."""
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


MODULE_SHAPES = ((BUCKET, 512, 7, 7), (BUCKET, 64, 56, 56))  # backbone stage outputs
MODULE_TOL = 1e-4       # a module's card forward against its CPU forward, f32, TF32 off


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
    """Phase 14 (b): CBAMBlock and SelfAttention2D at the backbone's
    stage-output shapes: the card's f32 forward (TF32 off) against the same
    module's CPU forward within 1e-4; CBAMBlock launches the SE kernel once
    per eval call, in f32 and in bf16. Returns the numbers and the kernel
    launches of the checked calls."""
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


# Phase 18 (b)'s writer: the port's state_dict key → the flax module path and
# kind, the inverse of compat/jax_weights.py:_torch_key (each result is
# checked against it)
_FLAX_MODULES = (
    (r"image_encoder\.stem\.0", "image_encoder/stem_conv", "conv"),
    (r"image_encoder\.stem\.1", "image_encoder/stem_bn", "norm"),
    (r"image_encoder\.(stage\d+)\.attention\.se\.(fc\d)", r"image_encoder/\1/attention/se/\2",
     "dense"),
    (r"image_encoder\.(stage\d+)\.attention\.spatial\.conv",
     r"image_encoder/\1/attention/spatial/conv", "conv"),
    (r"image_encoder\.(stage\d+)\.blocks\.(\d+)\.(conv\d)", r"image_encoder/\1/block\2/\3", "conv"),
    (r"image_encoder\.(stage\d+)\.blocks\.(\d+)\.(bn\d)", r"image_encoder/\1/block\2/\3", "norm"),
    (r"image_encoder\.(stage\d+)\.blocks\.(\d+)\.downsample\.0",
     r"image_encoder/\1/block\2/down_conv", "conv"),
    (r"image_encoder\.(stage\d+)\.blocks\.(\d+)\.downsample\.1",
     r"image_encoder/\1/block\2/down_bn", "norm"),
    (r"text_encoder\.token_embedding", "text_encoder/token_embedding", "embed"),
    (r"text_encoder\.final_norm", "text_encoder/final_norm", "norm"),
    (r"text_encoder\.layers\.(\d+)\.self_attention\.(W_\w)",
     r"text_encoder/layer\1/self_attention/\2", "dense"),
    (r"text_encoder\.layers\.(\d+)\.(norm\d)", r"text_encoder/layer\1/\2", "norm"),
    (r"text_encoder\.layers\.(\d+)\.ffn\.(fc\d)", r"text_encoder/layer\1/ffn/\2", "dense"),
    (r"fusion\.image_projector\.projection\.0", "fusion/image_projector/proj", "dense"),
    (r"fusion\.image_projector\.projection\.1", "fusion/image_projector/proj_norm", "norm"),
    (r"fusion\.image_projector", "fusion/image_projector", "param"),
    (r"fusion\.cross_attention\.layers\.(\d+)\.(norm_\w+)", r"fusion/cross_attention/layer\1/\2",
     "norm"),
    (r"fusion\.cross_attention\.layers\.(\d+)\.cross_attention\.(W_\w)",
     r"fusion/cross_attention/layer\1/cross_attention/\2", "dense"),
    (r"fusion\.cross_attention\.layers\.(\d+)\.ffn\.0", r"fusion/cross_attention/layer\1/ffn_fc1",
     "dense"),
    (r"fusion\.cross_attention\.layers\.(\d+)\.ffn\.3", r"fusion/cross_attention/layer\1/ffn_fc2",
     "dense"),
    (r"fusion\.gate\.gate\.0", "fusion/gate/gate", "dense"),
    (r"fusion\.output_norm", "fusion/output_norm", "norm"),
    (r"answer_head\.classifier\.0", "answer_head/fc1", "dense"),
    (r"answer_head\.classifier\.3", "answer_head/fc2", "dense"),
    (r"answer_head\.classifier\.6", "answer_head/fc3", "dense"),
)
_FLAX_LEAVES = {"conv": {"weight": "kernel"}, "dense": {"weight": "kernel", "bias": "bias"},
                "embed": {"weight": "embedding"},
                "norm": {"weight": "scale", "bias": "bias", "running_mean": "mean",
                         "running_var": "var"},
                "param": {"position_embedding": "position_embedding"}}


def flax_leaf(key: str, value: np.ndarray):
    """(collection, flax path, array in flax's layout) of one state_dict
    entry, or None for what flax does not store (``pe``,
    ``num_batches_tracked``)."""
    import re

    from vqa_tpu_torch.compat import jax_weights

    module, leaf = key.rsplit(".", 1)
    if leaf == "num_batches_tracked" or key == "text_encoder.positional_encoding.pe":
        return None
    for pattern, template, kind in _FLAX_MODULES:
        if re.fullmatch(pattern, module) and leaf in _FLAX_LEAVES[kind]:
            path = tuple(re.sub(pattern, template, module).split("/")) + (
                _FLAX_LEAVES[kind][leaf],)
            collection = "batch_stats" if leaf.startswith("running_") else "params"
            back, transform = jax_weights._torch_key(collection, path)
            require(back == key, f"flax_leaf({key}) → {'/'.join(path)} maps back to {back}")
            if transform is jax_weights._conv_kernel:
                value = np.transpose(value, (2, 3, 1, 0))  # OIHW → HWIO
            elif transform is jax_weights._linear_kernel:
                value = value.T
            return collection, path, np.ascontiguousarray(value, np.float32)
    raise KeyError(f"no flax path for {key}")


def flax_variables(state_dict) -> dict:
    """The port's state_dict (numpy arrays) as flax ``{'params',
    'batch_stats'}`` trees."""
    out = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        leaf = flax_leaf(key, np.asarray(value))
        if leaf is None:
            continue
        collection, path, arr = leaf
        node = out[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def write_orbax_tree(path: str, tree) -> int:
    """``tree`` (dicts, lists, numpy arrays, Nones) as an Orbax checkpoint
    directory in the plain-directory zarr v2 layout, uncompressed, one
    chunk per array (``compat/orbax.py`` reads it; Orbax writes it with
    ``use_ocdbt=False``). Returns the bytes of array data written."""
    entries, written = {}, 0

    def walk(node, keys):
        nonlocal written
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + [(str(k), 2)])
            return
        if isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, keys + [(str(i), 1)])
            return
        name = ".".join(k for k, _ in keys)
        meta = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if node is None:
            meta["value_metadata"] = {"value_type": "None", "skip_deserialize": True}
        else:
            arr = np.array(node, order="C", copy=False) if np.ndim(node) else np.asarray(node)
            meta["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                      "write_shape": list(arr.shape)}
            folder = os.path.join(path, name)
            os.makedirs(folder)
            with open(os.path.join(folder, ".zarray"), "w", encoding="utf-8") as f:
                json.dump({"zarr_format": 2, "shape": list(arr.shape), "chunks": list(arr.shape),
                           "dtype": arr.dtype.str, "compressor": None, "fill_value": None,
                           "order": "C", "filters": None, "dimension_separator": "."}, f)
            with open(os.path.join(folder, ".".join(["0"] * max(arr.ndim, 1))), "wb") as f:
                f.write(arr.tobytes())
            written += arr.nbytes
        entries[str(tuple(k for k, _ in keys))] = meta

    os.makedirs(path)
    walk(tree, [])
    with open(os.path.join(path, "_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    return written


def write_trainer_tree(base: str, name: str, model, rng, step: int, meta: dict) -> int:
    """The JAX trainer's tree (``vqa_tpu/training/train.py:_state_tree``) of
    ``model``'s weights and BN statistics, with AdamW's moments of seeded
    values (mu ~ 1e-4·N(0, 1), nu = mu² + (1e-3·N(0, 1))², as gradients
    near 1e-3 leave them) and every count at ``step``, written to
    ``<base>/<name>/`` with its sidecar. Returns the array bytes."""
    from vqa_tpu_torch.utils.config import model_config_dict

    variables = flax_variables({k: v.detach().cpu().numpy()
                                for k, v in model.state_dict().items()})

    def like(tree, draw):
        return {k: like(v, draw) if isinstance(v, dict) else draw(v.shape)
                for k, v in tree.items()}

    mu = like(variables["params"], lambda s: (1e-4 * rng.standard_normal(s)).astype(np.float32))

    def second(tree, first):  # nu >= mu², as a mean of squares is
        return {k: second(v, first[k]) if isinstance(v, dict) else
                (np.square(first[k]) + np.square(1e-3 * rng.standard_normal(v.shape))
                 ).astype(np.float32) for k, v in tree.items()}

    nu = second(variables["params"], mu)
    count = np.asarray(step, np.int32)
    tree = {**variables, "opt_state": [None, [{"count": count, "mu": mu, "nu": nu}, None,
                                              {"count": count}]], "step": count}
    written = write_orbax_tree(os.path.join(base, name), tree)
    with open(os.path.join(base, name + ".meta.json"), "w", encoding="utf-8") as f:
        json.dump({"config": model_config_dict(model.config), "meta": meta}, f)
    return written


def mapped_moments(base: str, name: str, names) -> dict:
    """The tree's moments as ``compat/jax_weights.py`` maps them, on the
    CPU: {position: state}."""
    from vqa_tpu_torch.compat.jax_weights import adamw_state_from_jax
    from vqa_tpu_torch.compat.orbax import training_state
    from vqa_tpu_torch.training.checkpoint import load_orbax_checkpoint

    tree, _, _ = load_orbax_checkpoint(base, name)
    state = training_state(tree)
    return adamw_state_from_jax(state["mu"], state["nu"], state["adam_count"], names)
