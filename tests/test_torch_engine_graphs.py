"""The serving engine's graph bookkeeping (``serving/graphs.py``), on the CPU.

CUDA graphs exist only on the card, so here a stand-in graph takes the
place of each captured one: its replay runs the captured function again
from the static inputs into the static output, which is what a graph's
replay computes. Through it the engine's graphed dispatch runs as it does
on the card: the launches recorded at capture are added on every replay,
each dispatch returns a copy of the static output (so chunked and
pipelined dispatches do not alias), a bucket without a graph and a failed
capture raise, and nothing falls back to the eager forward.
``capture_bucket``'s own accounting runs with ``torch.cuda``'s stream and
graph calls replaced: the warm forwards count, the capture does not.
The CPU engine itself builds no graph; its probabilities against the
JAX engine's are ``tests/test_torch_engine.py``'s.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from vqa_tpu_torch import ops
from vqa_tpu_torch.ops._build import count_launch
from vqa_tpu_torch.parallel import mesh_from_config
from vqa_tpu_torch.serving import graphs
from vqa_tpu_torch.serving.batcher import MicroBatcher
from vqa_tpu_torch.serving.engine import VQAInference
from vqa_tpu_torch.utils.config import InferenceConfig, MeshConfig, tiny_model_config
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# what one eval forward launches on the card (phase 3 of chip_smoke.py)
PER_FORWARD = {"stem": 1, "se": 4, "cross_attention": 2}
BUCKETS = (1, 4)


class StandInGraph:
    """A captured graph's replay: the function again, from the static
    inputs into the static output."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output
        self.replays = 0

    def replay(self):
        self.output.copy_(self.fn(*self.inputs))
        self.replays += 1


def stand_in_capture(forward, inputs):
    out = {}
    for b in sorted(inputs, reverse=True):
        output = forward(*inputs[b])
        out[b] = graphs.BucketGraph(StandInGraph(forward, inputs[b], output), inputs[b],
                                    output, PER_FORWARD)
    return out


def _engine(monkeypatch, replicas=1):
    monkeypatch.setattr(graphs, "capture_replica", stand_in_capture)
    mesh = (mesh_from_config(MeshConfig(data_parallel=replicas), devices=["cpu"] * replicas)
            if replicas > 1 else None)
    engine = VQAInference(model_config=tiny_model_config(), device="cpu", seed=3, mesh=mesh,
                          config=InferenceConfig(batch_buckets=BUCKETS))
    engine._graphed = True
    return engine.load()


def _pixels(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def _questions(n):
    qs = ["what color is the cat", "how many dogs are there", "is this a man"]
    return [qs[i % 3] for i in range(n)]


def test_the_cpu_engine_builds_no_graph():
    engine = VQAInference(model_config=tiny_model_config(), device="cpu",
                          config=InferenceConfig(batch_buckets=BUCKETS))
    engine.warmup()
    assert engine._graphed is False and engine._graphs is None
    probs, n = engine.dispatch_probs_from_pixels(_pixels(3), _questions(3))
    assert n == 3 and probs.shape == (4, 16)


@pytest.mark.parametrize("replicas", [1, 2])
def test_every_replay_adds_the_launches_recorded_at_capture(monkeypatch, replicas):
    engine = _engine(monkeypatch, replicas=replicas)
    assert sorted(engine._graphs) == engine._effective_buckets()
    assert all(len(g) == replicas for g in engine._graphs.values())
    before = ops.launch_counts()
    for n in (1, 3, 4, 2):
        engine.dispatch_probs_from_pixels(_pixels(n, n), _questions(n))
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(ops.KERNELS, 0),
        **{k: 4 * replicas * v for k, v in PER_FORWARD.items()}}
    replays = sum(g.graph.replays for gs in engine._graphs.values() for g in gs)
    assert replays == 4 * replicas


@pytest.mark.parametrize("replicas", [1, 2])
def test_graphed_dispatch_matches_the_eager_forward(monkeypatch, replicas):
    engine = _engine(monkeypatch, replicas=replicas)
    for n in (1, 3, 4):
        pixels, qs = _pixels(n, 10 + n), _questions(n)
        got, k = engine.dispatch_probs_from_pixels(pixels, qs)
        want, _ = engine._dispatch_eager(pixels, qs)
        assert k == n and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6


def test_a_dispatch_returns_a_copy_of_the_static_output(monkeypatch):
    engine = _engine(monkeypatch)
    (graph,) = engine._graphs[4]
    first, _ = engine.dispatch_probs_from_pixels(_pixels(4, 1), _questions(4))
    kept = first.clone()
    assert first.data_ptr() != graph.output.data_ptr()
    second, _ = engine.dispatch_probs_from_pixels(_pixels(4, 2), _questions(4))
    assert not torch.equal(second, kept)  # the replay rewrote the static output
    assert torch.equal(first, kept)       # and not the first dispatch's result


def test_chunks_dispatched_before_any_fetch_do_not_alias(monkeypatch):
    """10 rows at a largest bucket of 4: three chunks, all dispatched before
    the first is fetched, each equal to that chunk dispatched alone."""
    engine = _engine(monkeypatch)
    pixels, qs = _pixels(10, 5), _questions(10)
    got = engine.predict_probs_from_pixels(pixels, qs)
    alone = np.concatenate([engine.predict_probs_from_pixels(pixels[i:i + 4], qs[i:i + 4])
                            for i in range(0, 10, 4)])
    assert got.shape == (10, 16)
    np.testing.assert_array_equal(got, alone)
    assert len({tuple(np.round(r, 6)) for r in got}) > 1


def test_pipelined_groups_through_the_batcher_do_not_alias(monkeypatch):
    """Concurrent submits through the batcher (two groups in flight): each
    answer within 1e-4 of the same request alone."""
    engine = _engine(monkeypatch)
    pixels, qs = _pixels(12, 9), _questions(12)
    want = [engine.predict_probs_from_pixels(pixels[i:i + 1], qs[i:i + 1])[0]
            for i in range(12)]
    batcher = MicroBatcher(engine, batch_timeout_ms=20.0)
    results = [None] * 12
    barrier = threading.Barrier(12)

    def call(i):
        barrier.wait()
        results[i] = batcher.submit(pixels[i], qs[i], top_k=3)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert batcher.total_batches < 12
    for got, row in zip(results, want):
        for a in got["answers"]:
            assert abs(a["probability"] - float(row[a["index"]])) <= 1e-4


def test_a_bucket_without_a_graph_raises(monkeypatch):
    engine = _engine(monkeypatch)
    del engine._graphs[4]
    engine.dispatch_probs_from_pixels(_pixels(1), _questions(1))
    with pytest.raises(RuntimeError, match="no CUDA graph for bucket 4"):
        engine.dispatch_probs_from_pixels(_pixels(3), _questions(3))


def test_a_failed_capture_raises_and_nothing_runs_eagerly(monkeypatch):
    def failing_capture(forward, inputs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "capture_replica", failing_capture)
    engine = VQAInference(model_config=tiny_model_config(), device="cpu",
                          config=InferenceConfig(batch_buckets=BUCKETS))
    engine._graphed = True
    with pytest.raises(RuntimeError, match="stream is capturing"):
        engine.load()
    assert engine._graphs is None
    eager = []
    monkeypatch.setattr(engine, "_dispatch_eager", lambda *a: eager.append(a))
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        engine.dispatch_probs_from_pixels(_pixels(1), _questions(1))
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        engine.predict_batch_raw([_pixels(1)[0]], _questions(1))
    assert eager == []


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    pass


def _cpu_cuda(monkeypatch, graph_ctx=contextlib.nullcontext):
    """``torch.cuda``'s stream and graph calls as no-ops, so that
    ``capture_bucket`` runs its accounting on the CPU."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: graph_ctx())


def _counted_forward(x):
    """An eval forward's launches, as the wrappers count them on the card."""
    count_launch(ops.fused_stem)
    for _ in range(4):
        count_launch(ops.fused_se)
    for _ in range(2):
        count_launch(ops.fused_cross_attention)
    return x * 2


def test_capture_counts_the_warm_forwards_and_takes_back_the_captured_one(monkeypatch):
    _cpu_cuda(monkeypatch)
    before = ops.launch_counts()
    g = graphs.capture_bucket(_counted_forward, [torch.ones(3)], pool=None)
    after = ops.launch_counts()
    assert g.launches == PER_FORWARD
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(ops.KERNELS, 0),
        **{k: graphs.WARM_FORWARDS * v for k, v in PER_FORWARD.items()}}
    assert torch.equal(g.output, torch.full((3,), 2.0))


def test_a_capture_that_fails_takes_back_its_counts_and_raises(monkeypatch):
    @contextlib.contextmanager
    def failing():
        yield
        raise RuntimeError("capture invalidated")

    _cpu_cuda(monkeypatch, failing)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="capture invalidated"):
        graphs.capture_bucket(_counted_forward, [torch.ones(3)], pool=None)
    after = ops.launch_counts()
    assert after["stem"] - before["stem"] == graphs.WARM_FORWARDS
