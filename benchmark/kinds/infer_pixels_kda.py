"""Batch scoring with the hybrid decoder model: one caller, a closed loop of
`predict_probs_from_pixels`.

`infer_pixels_decoder.py`'s loop, set-up, window, traced sub-window,
comparison and notes (its docstring says what each holds; its `inputs`,
`program_routes`, `gaps` and `routing_note` are imported), for a
configuration whose decoder mixes Kimi Delta Attention and MLA
(`reference/kimi_linear_vqa.py`), with its own weights, reference and
control:

- weights: `harness/kimi_linear_weights.py`, drawn on the device tensor by
  tensor and written to the deployment in bfloat16;
- the reference: `reference/kimi_linear_vqa.py` in float32 from the same
  bfloat16 values, on the same sampled pairs, once the engine is freed,
  with every token's experts pinned to the program's choices (read as the
  decoder kind reads them): at 256 experts and 8 a token, bf16 rounding
  alone moves some layer's choice for nearly every token, and those flips,
  not the arithmetic, would set the gaps. The routing note compares the
  program's choices with the reference's own;
- the control: the reference in fp8 routes freely, and the float32
  reference is pinned to its choices, as it is to the program's;
- the checks: the traffic's `limits` over `compared`'s numbers:
  `logprob_gap` and `logprob_gap_p99` as in the decoder kind, and
  `gap_over_bf16`, the program's `logprob_gap_p99` over that of the
  reference with its products' operands rounded to bf16 (pinned to the
  same choices), which holds the program to bf16's own error on the
  seed's weights; a note gives each.

A program without Kimi Delta Attention stops at once: the configuration
cannot be run there.
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import kimi_linear_weights, weights
from benchmark.harness.record import Check, Record, annotated
from benchmark.harness.trace import named, profiled
from benchmark.kinds.infer_pixels import annotated_dispatch, call_spread
from benchmark.kinds.infer_pixels_decoder import gaps, inputs, program_routes, routing_note
from benchmark.reference.kimi_linear_vqa import log_probs_in_blocks
from benchmark.reference.prep import Vocabulary


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda") -> Record:
    from vqa_tpu_torch.models.decoder import KDA  # noqa: F401 (the program has linear attention)
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    p, cfg = cell.traffic, cell.model
    rec = Record(cell=cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cell.dtype)
    with tempfile.TemporaryDirectory(prefix="bench_infer_") as tmp:
        vocab, pool, qs = inputs(cell, seed, dev)
        state = kimi_linear_weights.make_state(cfg, seed, dev)
        state_cpu = weights.write_deployment(tmp, cfg, state, list(vocab))
        del state
        if cuda:  # the inputs are off the card: from here on the peak is the engine's
            torch.cuda.empty_cache()
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
        rec.trace_counts["calls"] = m
        if rec.trace is not None and not named(rec.trace):
            gaps = profiled(sub_window, cpu=True)[0]
            rec.trace_idle = gaps["idle"] if gaps else None
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    filled = min(seen, k)
    rows = kept_rows[:filled]
    routes = program_routes(engine, pool[rows], [qs[r] for r in rows], p["bucket"])
    del engine, dispatch  # the bound method holds the engine: the reference needs the card
    gc.collect()

    t_ref = time.perf_counter()
    args = (cfg, state_cpu, pool[rows], [qs[r] for r in rows], vocab, dev)
    ref, ref_routes = reference(*args, routes=routes)
    floor = reference(*args, quant=bf16, routes=routes)[0]
    readings = compared(kept_probs[:filled], ref, floor)
    for name, limit in p["limits"].items():
        rec.checks[name] = Check(readings[name], limit)
    rec.notes.append("gaps: " + ", ".join(f"{k} {v:.6f}" for k, v in readings.items()))
    rec.notes.append(routing_note(cfg, routes, ref_routes))
    rec.notes.append(f"reference: {filled} pairs compared in "
                     f"{time.perf_counter() - t_ref:.3f} s")
    return rec


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back: what a bf16 operand of a product holds."""
    return x.to(torch.bfloat16).float()


def compared(probs: np.ndarray, ref_lp: np.ndarray, floor_lp: np.ndarray) -> dict:
    """`gaps` of `probs` against the float32 reference, and
    `gap_over_bf16`: their `logprob_gap_p99` over that of the reference
    with every product's operands rounded to bf16 (`floor_lp`, pinned to
    the same choices), the gap bf16 rounding alone opens on these weights
    and pairs. How far a seed's weights carry a rounding to the readout
    varies severalfold from seed to seed; the ratio divides that out."""
    out = gaps(probs, ref_lp)
    out["bf16_logprob_gap_p99"] = gaps(np.exp(floor_lp), ref_lp)["logprob_gap_p99"]
    out["gap_over_bf16"] = out["logprob_gap_p99"] / out["bf16_logprob_gap_p99"]
    return out


def reference(cfg, state_cpu, pixels, questions, vocab, dev, quant=None, routes=None):
    """(ln p [n, answers] float64, each MoE layer's own choices) of the
    reference on `dev`, from the bfloat16 values as float32, its experts
    pinned to `routes` where given."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ids, mask = Vocabulary(weights.word_table(list(vocab)),
                           cfg["max_question_length"]).encode_all(questions)
    state = {k: v.to(dev).float() if v.is_floating_point() else v.to(dev)
             for k, v in state_cpu.items()}
    lp, routes = log_probs_in_blocks(cfg, state, torch.from_numpy(pixels).to(dev),
                                     torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(mask).to(dev), quant=quant,
                                     routes=routes)
    del state
    return lp.double().numpy(), routes


def control_readings(cell, seed: int, device="cuda") -> dict:
    """The control: the reference in fp8 (every operand of every product
    rounded to float8 e4m3) in the program's place, on `check_rows` pairs
    of the seed's pool, against the float32 reference pinned to its
    choices; the numbers `compared` gives, and the share of tokens the
    float32 reference would have routed otherwise."""
    from benchmark.reference.model import fp8

    p, cfg = cell.traffic, cell.model
    dev = torch.device(device)
    vocab, pool, qs = inputs(cell, seed, dev)
    state_cpu = {k: v.cpu() for k, v in kimi_linear_weights.make_state(cfg, seed, dev).items()}
    rows = np.random.default_rng([seed, 0xC0]).choice(p["pool_pairs"], p["check_rows"],
                                                     replace=False)
    args = (cfg, state_cpu, pool[rows], [qs[r] for r in rows], vocab, dev)
    low, low_routes = reference(*args, quant=fp8)
    ref, ref_routes = reference(*args, routes=low_routes)
    out = compared(np.exp(low), ref, reference(*args, quant=bf16, routes=low_routes)[0])
    out["routing"] = routing_note(cfg, low_routes, ref_routes)
    return out
