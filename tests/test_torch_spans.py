"""The port's span recorder (``vqa_tpu_torch/utils/profiling.py``) and the
spans of the inference engine, on the CPU.

The recorder: nesting and parent ids, the ring's wrap and its total,
spans from several threads at once, and a ``record_function`` range only
while a profiler runs. Under a CPU profiler the engine's spans appear as
user annotations on the profiler's own timestamps, ``engine.dispatch``
enclosing its children. A tiny CPU engine records one ``engine.dispatch``
with its ``engine.tokenize``, ``engine.stage`` and ``engine.replay`` per
chunk, one ``engine.fetch`` per call, and its set-up spans. Every test
reads the process's rings from the totals it found on entry, so spans
left by other tests in the same process do not count.
"""

from __future__ import annotations

import gc
import sys
import threading

import numpy as np
import pytest
import torch

from vqa_tpu_torch.ops import _build
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.training import checkpoint as ckpt_lib
from vqa_tpu_torch.utils import profiling
from vqa_tpu_torch.utils.config import InferenceConfig, tiny_model_config
from vqa_tpu_torch.utils.profiling import RING_SIZE, annotate, spans, step_annotation
from test_torch_engine_graphs import _engine as _graphed_engine
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENGINE_SPANS = ("engine.dispatch", "engine.tokenize", "engine.stage", "engine.replay",
                "engine.fetch")


def since(name, total):
    """The records of ``name`` from its ``total``-th on."""
    records, _ = spans(name)
    return [r for r in records if r.seq >= total]


def totals(*names):
    return {n: spans(n)[1] for n in names}


def test_nested_spans_record_their_parents_and_values():
    start = totals("t.outer", "t.inner")
    with annotate("t.outer", 7) as outer:
        with annotate("t.inner"):
            pass
        with annotate("t.inner") as second:
            second.value = 3
    (o,) = since("t.outer", start["t.outer"])
    inner = since("t.inner", start["t.inner"])
    assert [r.seq for r in inner] == [start["t.inner"], start["t.inner"] + 1]
    assert [r.parent for r in inner] == [o.id, o.id] and o.value == 7 and outer.value == 7
    assert [r.value for r in inner] == [0, 3]
    assert inner[0].id != inner[1].id
    for r in inner:  # the children lie inside their parent, on one clock
        assert o.start_ns <= r.start_ns <= r.end_ns <= o.end_ns
    with annotate("t.outer"):
        pass
    assert since("t.outer", start["t.outer"] + 1)[0].parent == 0


def test_phases_follow_one_another_inside_their_span():
    start = totals("t.phased", "t.p1", "t.p2", "t.inside")
    with annotate("t.phased") as span:
        span.phase("t.p1")
        with annotate("t.inside"):
            pass
        span.phase("t.p2")
    (outer,) = since("t.phased", start["t.phased"])
    (p1,), (p2,) = since("t.p1", start["t.p1"]), since("t.p2", start["t.p2"])
    (inside,) = since("t.inside", start["t.inside"])
    assert p1.parent == p2.parent == inside.parent == outer.id
    assert len({outer.id, p1.id, p2.id, inside.id}) == 4
    assert outer.start_ns <= p1.start_ns <= inside.start_ns <= inside.end_ns <= p1.end_ns
    assert p1.end_ns == p2.start_ns and p2.end_ns == outer.end_ns
    with annotate("t.phased"):  # a span without phases records none
        pass
    assert len(since("t.p2", start["t.p2"])) == 1


def test_phases_are_ranges_under_a_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("t.ranged") as span:
            span.phase("t.first")
            torch.ones(4).sum()
            span.phase("t.second")
    got = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()}
    (a, b), (f0, f1), (s0, s1) = got["t.ranged"], got["t.first"], got["t.second"]
    assert a <= f0 <= f1 <= s0 <= s1 <= b


def test_an_exception_closes_the_span_and_restores_its_parent():
    start = totals("t.raises", "t.after")
    with annotate("t.around") as around:
        with pytest.raises(ValueError):
            with annotate("t.raises"):
                raise ValueError("inside")
        with annotate("t.after"):
            pass
    assert since("t.raises", start["t.raises"])[0].parent == around.id
    assert since("t.after", start["t.after"])[0].parent == around.id


def test_the_ring_wraps_and_keeps_the_total():
    name = "t.wrap"
    extra = 37
    for i in range(RING_SIZE + extra):
        with annotate(name, i & 0xFF):
            pass
    records, total = spans(name)
    assert total == RING_SIZE + extra and len(records) == RING_SIZE
    assert [r.seq for r in records] == list(range(extra, RING_SIZE + extra))
    assert records[0].value == extra & 0xFF
    assert spans("t.never_recorded") == ([], 0)


def test_spans_from_several_threads_lose_none_and_keep_their_own_parents():
    name, child = "t.threaded", "t.threaded.child"
    start = totals(name, child)
    threads, per = 12, 400
    parents = [set() for _ in range(threads)]
    barrier = threading.Barrier(threads)

    def work(k):
        barrier.wait(timeout=30)
        for _ in range(per):
            with annotate(name, k) as span:
                parents[k].add(span.id)
                with annotate(child, k):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    outer, inner = since(name, start[name]), since(child, start[child])
    n = threads * per
    assert [r.seq for r in outer] == list(range(start[name], start[name] + n))
    assert [r.seq for r in inner] == list(range(start[child], start[child] + n))
    assert len({r.id for r in outer}) == n
    for r in inner:  # each child's parent is a span of its own thread
        assert r.parent in parents[r.value]
    assert all(r.parent == 0 for r in outer)


def test_a_range_opens_only_while_a_profiler_runs(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with annotate("t.quiet"):
        with step_annotation("t.step", 3):
            pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("t.loud"):
            with step_annotation("t.step", 4):
                pass
    assert opened == ["t.loud", "t.step#4"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"t.loud", "t.step#4"} <= names and "t.quiet" not in names


def test_step_annotation_outside_a_profiler_records_nothing():
    before = dict(profiling._rings)
    with step_annotation("t.steps", 12):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0 and "t.steps#12" not in profiling._rings
    assert profiling._rings.keys() == before.keys()


def _cpu_engine(buckets=(1, 4)):
    return VQAInference(model_config=tiny_model_config(), device="cpu", seed=3,
                        config=InferenceConfig(batch_buckets=buckets)).load()


def _pixels(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def _questions(n):
    qs = ["what color is the cat", "how many dogs are there", "is this a man"]
    return [qs[i % 3] for i in range(n)]


@pytest.mark.parametrize("n,chunks", [(1, 1), (4, 1), (10, 3)])
def test_a_cpu_engine_records_a_dispatch_with_its_children_per_chunk(n, chunks):
    engine = _cpu_engine()
    start = totals(*ENGINE_SPANS)
    probs = engine.predict_probs_from_pixels(_pixels(n), _questions(n))
    assert probs.shape == (n, engine.model.config.num_answers)
    got = {name: since(name, start[name]) for name in ENGINE_SPANS}
    dispatches = got["engine.dispatch"]
    assert len(dispatches) == chunks
    assert all(d.value == 1 for d in dispatches)  # the CPU finishes each forward at once
    ids = [d.id for d in dispatches]
    for child in ("engine.tokenize", "engine.stage", "engine.replay"):
        assert [r.parent for r in got[child]] == ids, child
    (fetch,) = got["engine.fetch"]
    assert fetch.start_ns >= dispatches[-1].end_ns  # every chunk is launched first
    for d, tok, stage, replay in zip(dispatches, got["engine.tokenize"], got["engine.stage"],
                                     got["engine.replay"]):
        assert d.start_ns <= tok.start_ns <= tok.end_ns <= stage.start_ns
        assert stage.end_ns <= replay.start_ns <= replay.end_ns <= d.end_ns


def test_graphed_dispatch_records_its_phases_across_replicas(monkeypatch):
    """The graphed path (stand-in graphs on the CPU), two replicas: one
    tokenize, one stage (both replicas' staging) and one replay (both
    replicas' replays) per dispatch, and the capture under
    ``engine.load.graphs``."""
    start = totals("engine.load.graphs", *ENGINE_SPANS)
    engine = _graphed_engine(monkeypatch, replicas=2)
    assert len(since("engine.load.graphs", start["engine.load.graphs"])) == 1
    engine.predict_probs_from_pixels(_pixels(3), _questions(3))  # bucket 4, 2 rows a replica
    (d,) = since("engine.dispatch", start["engine.dispatch"])
    for child in ("engine.tokenize", "engine.stage", "engine.replay"):
        assert [r.parent for r in since(child, start[child])] == [d.id], child
    assert len(since("engine.fetch", start["engine.fetch"])) == 1


def test_the_engines_spans_sit_on_the_profilers_timeline():
    """Under a CPU profiler each span is a user annotation on the
    profiler's own timestamps: ``engine.dispatch`` encloses
    ``engine.tokenize``, ``engine.stage`` and ``engine.replay`` (the eager
    path), in that order."""
    engine = _cpu_engine()
    engine.predict_probs_from_pixels(_pixels(3), _questions(3))  # warm
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.predict_probs_from_pixels(_pixels(3), _questions(3))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in ENGINE_SPANS:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert {k: len(v) for k, v in events.items()} == {k: 1 for k in ENGINE_SPANS}
    (d0, d1), = events["engine.dispatch"]
    order = [events[k][0] for k in ("engine.tokenize", "engine.stage", "engine.replay")]
    assert d0 <= order[0][0] and order[-1][1] <= d1
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    (f0, _), = events["engine.fetch"]
    assert f0 >= d1


def test_loading_a_checkpoint_records_weights_with_the_init_inside(tmp_path):
    from vqa_tpu_torch.models.vqa_model import create_vqa_model

    cfg = tiny_model_config()
    model = create_vqa_model(config=cfg, device="cpu", seed=1)
    ckpt_lib.save_checkpoint(str(tmp_path), "best_model",
                             {"model_state_dict": model.state_dict()}, cfg, {})
    start = totals("engine.load.weights", "model.init")
    engine = VQAInference(checkpoint_dir=str(tmp_path), device="cpu").load()
    assert engine.model_loaded_from_checkpoint
    (w,) = since("engine.load.weights", start["engine.load.weights"])
    (init,) = since("model.init", start["model.init"])
    assert init.parent == w.id and w.start_ns <= init.start_ns <= init.end_ns <= w.end_ns
    # no checkpoint: the seeded model is the weights, with no init to overwrite
    VQAInference(model_config=cfg, device="cpu").load()
    assert len(since("engine.load.weights", start["engine.load.weights"])) == 2
    assert len(since("model.init", start["model.init"])) == 1


def test_a_kernel_build_is_a_span(monkeypatch):
    monkeypatch.setattr(_build, "_build", lambda verbose: "/built/lib.so")
    start = totals("ops.build")
    with annotate("t.capture") as outer:
        assert _build.build() == "/built/lib.so"
    (b,) = since("ops.build", start["ops.build"])
    assert b.parent == outer.id


def test_watch_gc_records_each_collection_with_its_generation():
    profiling.watch_gc()
    profiling.watch_gc()
    assert gc.callbacks.count(profiling._on_gc) == 1
    start = totals("python.gc")
    with annotate("t.collecting") as outer:
        gc.collect(1)
        gc.collect()
    inside = [r.value for r in since("python.gc", start["python.gc"]) if r.parent == outer.id]
    assert 1 in inside and 2 in inside[inside.index(1):]  # collections on their own may interleave
