"""Batch scoring: one caller, a closed loop of `predict_probs_from_pixels`.

What the evaluator and batch scoring do. Set-up draws the weights, the
word table and the answer table from the seed, writes them as a
deployment directory in the run's temporary directory, and loads
`VQAInference` from it with the traffic's batch bucket as its only bucket
(so only that graph is captured). A host pool of `pool_pairs` pairs
(uint8 pixels at the configuration's image size, questions of
`question_words` words) is drawn from the seed; call i takes the
pool's `call_pairs` pairs from position (i * call_pairs) mod pool_pairs, as
a view (the pool holds whole calls), so the caller copies nothing.
`warm_calls` calls end set-up; the window then calls until `--seconds`
have passed, and every pair of every call counts.

Outputs: a reservoir sample, drawn from the seed, of `check_rows` answered
pairs keeps each pair's probabilities; once the window has closed, the
peak memory read and the engine freed, the reference scores the same
pairs (`logprob_gap`).

The device's peak memory is read from after the harness's own inputs are
drawn and off the card, so it is the engine's: its weights, its graph and
its staging, through load, capture, warm-up and the window. Each call's
host time is kept, and a note gives their spread and the rate in each
quarter of the window.

With `--trace 1` the window also times each bucket dispatch
(`engine.dispatch`), and a traced sub-window of `trace_seconds` follows it
with the calls and dispatches annotated, profiled with device activity
only. Where that profile recorded no host annotation, a second sub-window
profiled with host activity too names the breakdown's idle gaps.
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import compare, weights
from benchmark.harness.record import Check, Record, annotated
from benchmark.harness.trace import named, profiled


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda") -> Record:
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    p, cfg = cell.traffic, cell.model
    rec = Record(cell=cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cell.dtype)
    with tempfile.TemporaryDirectory(prefix="bench_infer_") as tmp:
        state = weights.make_state(cfg, seed, dev)
        vocab = weights.words(cfg["vocab_size"] - len(weights.SPECIALS), seed)
        state_cpu = weights.write_deployment(tmp, cfg, state, vocab)
        del state
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1)
        s = cfg["image_size"]
        pool = torch.randint(0, 256, (p["pool_pairs"], s, s, 3), generator=g, device=dev,
                             dtype=torch.uint8).cpu().numpy()
        qs = weights.questions(vocab, p["pool_pairs"], *p["question_words"], seed)
        if cuda:  # the inputs are off the card: from here on the peak is the engine's
            torch.cuda.reset_peak_memory_stats()
        engine = VQAInference(checkpoint_dir=tmp, checkpoint_name=weights.CHECKPOINT,
                              config=InferenceConfig(batch_buckets=(p["bucket"],),
                                                     max_batch_size=p["bucket"]),
                              device=dev, dtype=dtype)
        engine.load()
    n = p["call_pairs"]
    if p["pool_pairs"] % n:
        raise ValueError("the pool must hold a whole number of calls")
    slots = p["pool_pairs"] // n

    def call(i):
        """The pool rows of call i and their probabilities; the pixels go
        in as a view of the pool, the questions as a list made at set-up."""
        a = (i % slots) * n
        return slot_rows[i % slots], engine.predict_probs_from_pixels(
            pool[a:a + n], slot_questions[i % slots])

    slot_rows = [np.arange(j * n, (j + 1) * n) for j in range(slots)]
    slot_questions = [qs[j * n:(j + 1) * n] for j in range(slots)]

    for i in range(p["warm_calls"]):
        call(i)
    dispatch = engine.dispatch_probs_from_pixels
    if trace:
        engine.dispatch_probs_from_pixels = rec.span("engine.dispatch")(dispatch)

    rng = np.random.default_rng([seed, 0x5A3])
    k = p["check_rows"]
    kept_rows = np.zeros(k, np.int64)
    kept_probs = np.zeros((k, cfg["num_answers"]), np.float32)
    seen = calls = 0
    ends = []
    rec.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    while True:
        rows, probs = call(calls)
        ends.append(time.perf_counter())
        calls += 1
        # reservoir sample (Algorithm R) over every answered pair
        pos = np.arange(seen, seen + n)
        slot = np.where(pos < k, pos, rng.integers(0, pos + 1))
        take = slot < k
        kept_rows[slot[take]] = rows[take]
        kept_probs[slot[take]] = probs[take]
        seen += n
        if time.perf_counter() - start >= seconds:
            break
    rec.window_s = time.perf_counter() - start
    rec.attempted = rec.counts["pairs"] = seen
    rec.counts["calls"] = calls
    rec.counts["forwards"] = calls * (-(-n // p["bucket"]))
    rec.notes.append(call_spread(start, ends, n))
    if trace:
        engine.dispatch_probs_from_pixels = annotated_dispatch(dispatch)
        done = [calls]

        def sub_window():
            t1, m = time.perf_counter(), 0
            while time.perf_counter() - t1 < p["trace_seconds"]:
                with annotated("call", True):
                    call(done[0])
                done[0] += 1
                m += 1
            return m

        rec.trace, rec.trace_reason, m = profiled(sub_window)
        rec.trace_counts["forwards"] = m * (-(-n // p["bucket"]))
        if rec.trace is not None and not named(rec.trace):
            gaps = profiled(sub_window, cpu=True)[0]
            rec.trace_idle = gaps["idle"] if gaps else None
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del engine
    gc.collect()

    t_ref = time.perf_counter()
    filled = min(seen, k)
    rows = kept_rows[:filled]
    ref = compare.reference_log_probs(cfg, state_cpu, pool[rows], [qs[r] for r in rows],
                                      weights.word_table(vocab), dev)
    rec.checks["logprob_gap"] = Check(compare.logprob_gap(kept_probs[:filled], ref),
                                      p["limits"]["logprob_gap"])
    rec.notes.append(f"reference: {filled} pairs compared in "
                     f"{time.perf_counter() - t_ref:.3f} s")
    return rec


def call_spread(start: float, ends, pairs_per_call: int) -> str:
    """The window's calls: host ms per call (10th, 50th, 90th percentile and
    the longest) and pairs/s in each quarter of the window."""
    ms = np.diff(np.concatenate([[start], ends])) * 1e3
    q = np.percentile(ms, [10, 50, 90])
    span = ends[-1] - start
    quarter = np.minimum(((np.asarray(ends) - start) / span * 4).astype(int), 3)
    rates = [pairs_per_call * int((quarter == i).sum()) / (span / 4) for i in range(4)]
    return (f"window: {len(ms)} calls, host ms per call p10 {q[0]:.3f} p50 {q[1]:.3f} "
            f"p90 {q[2]:.3f} max {ms.max():.3f}; pairs/s by quarter "
            + " ".join(f"{r:.1f}" for r in rates))


def annotated_dispatch(fn):
    def dispatch(*args, **kwargs):
        with annotated("dispatch", True):
            return fn(*args, **kwargs)
    return dispatch


def control_readings(cell, seed: int, device="cuda") -> dict:
    """The control of `logprob_gap`: the reference in fp8 (every operand of
    every product rounded to float8 e4m3) in the program's place, on
    `check_rows` pairs of the seed's pool, against the float32 reference."""
    from benchmark.reference.model import fp8

    p, cfg = cell.traffic, cell.model
    dev = torch.device(device)
    state_cpu = {k: v.cpu() for k, v in weights.make_state(cfg, seed, dev).items()}
    vocab = weights.words(cfg["vocab_size"] - len(weights.SPECIALS), seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    s = cfg["image_size"]
    pool = torch.randint(0, 256, (p["pool_pairs"], s, s, 3), generator=g, device=dev,
                         dtype=torch.uint8).cpu().numpy()
    qs = weights.questions(vocab, p["pool_pairs"], *p["question_words"], seed)
    rows = np.random.default_rng([seed, 0xC0]).choice(p["pool_pairs"], p["check_rows"],
                                                     replace=False)
    args = (cfg, state_cpu, pool[rows], [qs[r] for r in rows], weights.word_table(vocab), dev)
    ref = compare.reference_log_probs(*args)
    low = compare.reference_log_probs(*args, quant=fp8)
    return {"logprob_gap": compare.logprob_gap(np.exp(low), ref)}
