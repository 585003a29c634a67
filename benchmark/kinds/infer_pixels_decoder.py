"""Batch scoring with the decoder model: one caller, a closed loop of
`predict_probs_from_pixels`.

`infer_pixels.py`'s loop (its docstring says what set-up, the window, the
traced sub-window and the peak memory read hold), for a configuration
whose fusion tower is the decoder with routed experts
(`reference/decoder_vqa.py`), with its own weights, reference and control:

- weights: `harness/decoder_weights.py`, drawn on the device tensor by
  tensor and written to the deployment in bfloat16; the word table holds
  `vocab_size` minus the four specials drawn words;
- the comparison: once the window has closed, the engine's routing of the
  sampled pairs is read from an eager forward of the loaded model (each
  MoE layer's choices), the engine is freed, and the reference scores the
  same pairs from the same bfloat16 values in float32. Checked: the
  traffic's `limits` (`logprob_gap`, the largest gap over every answer of
  every sampled pair, and `logprob_gap_p99`, the 99th percentile over the
  pairs of each pair's largest gap, where the traffic sets a limit for
  it); a note gives both, and the share of the sampled tokens whose
  choice of held experts differs, in some layer, between the program and
  the reference.

A program without the decoder model stops at once: the configuration
cannot be run there.
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import decoder_weights, weights
from benchmark.harness.compare import logprob_gap
from benchmark.harness.record import Check, Record, annotated
from benchmark.harness.trace import named, profiled
from benchmark.kinds.infer_pixels import annotated_dispatch, call_spread
from benchmark.reference.decoder_vqa import held_experts, log_probs_in_blocks
from benchmark.reference.prep import Vocabulary


def inputs(cell, seed: int, dev):
    """The seed's word list (an array), pixel pool and questions."""
    p, cfg = cell.traffic, cell.model
    vocab = np.array(weights.words(cfg["vocab_size"] - len(weights.SPECIALS), seed))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    s = cfg["image_size"]
    pool = torch.randint(0, 256, (p["pool_pairs"], s, s, 3), generator=g, device=dev,
                         dtype=torch.uint8).cpu().numpy()
    return vocab, pool, weights.questions(vocab, p["pool_pairs"], *p["question_words"], seed)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda") -> Record:
    from vqa_tpu_torch.models import decoder  # noqa: F401 (the program has the decoder model)
    from vqa_tpu_torch.serving.engine import VQAInference
    from vqa_tpu_torch.utils.config import InferenceConfig

    p, cfg = cell.traffic, cell.model
    rec = Record(cell=cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dtype = getattr(torch, cell.dtype)
    with tempfile.TemporaryDirectory(prefix="bench_infer_") as tmp:
        vocab, pool, qs = inputs(cell, seed, dev)
        state = decoder_weights.make_state(cfg, seed, dev)
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
    del engine
    gc.collect()

    t_ref = time.perf_counter()
    ref, ref_routes = reference(cfg, state_cpu, pool[rows], [qs[r] for r in rows], vocab, dev)
    check(rec, p["limits"], kept_probs[:filled], ref)
    rec.notes.append(routing_note(cfg, routes, ref_routes))
    rec.notes.append(f"reference: {filled} pairs compared in "
                     f"{time.perf_counter() - t_ref:.3f} s")
    return rec


def program_routes(engine, pixels, questions, bucket: int) -> torch.Tensor:
    """Each MoE layer's choices of every token of the pairs, from eager
    forwards of the engine's model in buckets: [layers, pairs, positions,
    k] on the CPU."""
    from vqa_tpu_torch.models.moe import MoEGate
    from vqa_tpu_torch.serving.engine import forward_probs

    model = engine.model
    gates = [m for m in model.modules() if isinstance(m, MoEGate)]
    chosen = []
    hooks = [g.register_forward_hook(lambda _m, _i, out: chosen.append(out[0]))
             for g in gates]
    out = []
    try:
        with torch.inference_mode():
            for i in range(0, len(questions), bucket):
                del chosen[:]
                ids, mask = engine.tokenizer.encode_batch_np(list(questions[i:i + bucket]))
                x = [torch.from_numpy(a).to(engine.device)
                     for a in (pixels[i:i + bucket], ids, mask)]
                forward_probs(model, *x)
                n = x[0].shape[0]
                out.append(torch.stack([c.reshape(n, -1, c.shape[-1]) for c in chosen]).cpu())
    finally:
        for h in hooks:
            h.remove()
    return torch.cat(out, 1)


def reference(cfg, state_cpu, pixels, questions, vocab, dev, quant=None):
    """(ln p [n, answers] float64, each MoE layer's choices) of the
    reference on `dev`, from the bfloat16 values as float32."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ids, mask = Vocabulary(weights.word_table(list(vocab)),
                           cfg["max_question_length"]).encode_all(questions)
    state = {k: v.to(dev).float() if v.is_floating_point() else v.to(dev)
             for k, v in state_cpu.items()}
    lp, routes = log_probs_in_blocks(cfg, state, torch.from_numpy(pixels).to(dev),
                                     torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(mask).to(dev), quant=quant)
    del state
    return lp.double().numpy(), routes


def gaps(probs: np.ndarray, ref_lp: np.ndarray) -> dict:
    """`logprob_gap` (compare.logprob_gap) and `logprob_gap_p99`, the 99th
    percentile over the pairs of each pair's largest gap."""
    lp = np.log(np.maximum(probs.astype(np.float64), np.finfo(np.float64).tiny))
    per_pair = np.abs(lp - ref_lp).max(1)
    return {"logprob_gap": logprob_gap(probs, ref_lp),
            "logprob_gap_p99": float(np.percentile(per_pair, 99))}


def check(rec, limits, probs, ref_lp) -> None:
    readings = gaps(probs, ref_lp)
    for name, limit in limits.items():
        rec.checks[name] = Check(readings[name], limit)
    rec.notes.append("gaps: " + ", ".join(f"{k} {v:.6f}" for k, v in readings.items()))


def held_sets(cfg, routes: torch.Tensor) -> torch.Tensor:
    """Each token's held experts, as a bit set, per layer."""
    held = torch.tensor(list(held_experts(cfg)))
    mine = (routes[..., None] == held).any(-2)  # [layers, pairs, positions, held]
    return (mine.long() << torch.arange(len(held))).sum(-1)


def routing_note(cfg, program: torch.Tensor, ref: torch.Tensor) -> str:
    differ = held_sets(cfg, program) != held_sets(cfg, ref)
    return (f"routing: {float(differ.any(0).float().mean()) * 100:.3f}% of the sampled tokens "
            f"chose other held experts than the reference in some layer "
            f"({float(differ.float().mean()) * 100:.4f}% of token-layer choices)")


def control_readings(cell, seed: int, device="cuda") -> dict:
    """The control: the reference in fp8 (every operand of every product
    rounded to float8 e4m3) in the program's place, on `check_rows` pairs
    of the seed's pool, against the float32 reference; both numbers, and
    the share of tokens routed otherwise."""
    from benchmark.reference.model import fp8

    p, cfg = cell.traffic, cell.model
    dev = torch.device(device)
    vocab, pool, qs = inputs(cell, seed, dev)
    state_cpu = {k: v.cpu() for k, v in decoder_weights.make_state(cfg, seed, dev).items()}
    rows = np.random.default_rng([seed, 0xC0]).choice(p["pool_pairs"], p["check_rows"],
                                                     replace=False)
    args = (cfg, state_cpu, pool[rows], [qs[r] for r in rows], vocab, dev)
    ref, ref_routes = reference(*args)
    low, low_routes = reference(*args, quant=fp8)
    out = gaps(np.exp(low), ref)
    out["routing"] = routing_note(cfg, low_routes, ref_routes)
    return out
