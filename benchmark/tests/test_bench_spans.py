"""The readers of the program's spans (`harness/program_spans.py` and the
`program_span` metrics that use it) on a hand-filled recorder: the window
taken by position, each reading, and None where the program has no
recorder, where it holds fewer records than the window and where its ring
has wrapped past the window. Last, a tiny run on the CPU through
`run.measure`, whose rings hold exactly the positions the readers assume."""

import os
import sys
from unittest import mock

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tiny import sound_limits, tiny_cell  # noqa: E402

from benchmark.harness import program_spans, spec  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402

DISPATCH = ["engine.tokenize_ms", "engine.stage_ms", "engine.replay_ms",
            "engine.starved_share", "host.gc_ms_per_s"]
SETUP = ["setup.weights_s", "setup.init_s", "setup.graphs_s"]
NEW = DISPATCH + ["engine.fetch_ms_per_call"] + SETUP
MS = 1_000_000


class Span:
    def __init__(self, seq, id, parent, start_ns, end_ns, value=0):
        self.seq, self.id, self.parent = seq, id, parent
        self.start_ns, self.end_ns, self.value = start_ns, end_ns, value


class Rings:
    """A hand-filled recorder: the records of each name, and its total."""

    def __init__(self):
        self.records, self.totals = {}, {}
        self._id = 0

    def add(self, name, start_ns, end_ns, value=0, parent=0):
        self._id += 1
        got = self.records.setdefault(name, [])
        seq = self.totals.get(name, 0)
        got.append(Span(seq, self._id, parent, start_ns, end_ns, value))
        self.totals[name] = seq + 1
        return got[-1]

    def spans(self, name):
        return list(self.records.get(name, [])), self.totals.get(name, 0)


def cell():
    c = tiny_cell("ref_infer_b32")  # 3 warm calls of 16 pairs at bucket 4
    assert (c.traffic["warm_calls"], c.traffic["call_pairs"], c.traffic["bucket"]) == (3, 16, 4)
    return c


def filled(calls=2, trailing=3):
    """Set-up, 3 warm calls, `calls` window calls and `trailing` calls of a
    traced sub-window: 4 dispatches and one fetch a call. Window dispatch k
    (from 0) starts at 1000 + 10k ms and lasts 2 ms: tokenize 0.25 ms,
    stage 0.5, replay 0.125; its value is 1 on the first of each call.
    Warm and trailing dispatches last 5 ms with children of 1 ms each. A
    window fetch lasts 3 ms, the others 7."""
    r = Rings()
    w = r.add("engine.load.weights", 0, 3000 * MS)
    r.add("model.init", 100 * MS, 900 * MS, parent=w.id)
    r.add("model.init", 5000 * MS, 5100 * MS)  # not this engine's
    g = r.add("engine.load.graphs", 3000 * MS, 7000 * MS)
    r.add("ops.build", 3100 * MS, 4100 * MS, parent=g.id)
    r.add("ops.build", 100 * MS, 200 * MS)  # outside the capture
    t, k = 0, 0
    for c in range(3 + calls + trailing):
        window = 3 <= c < 3 + calls
        for d in range(4):
            if window:
                start = 1000 * MS + 10 * MS * k
                k += 1
                parts, length, value = (MS // 4, MS // 2, MS // 8), 2 * MS, int(d == 0)
            else:
                start = (0 if c < 3 else 10**6 * MS) + t
                parts, length, value = (MS, MS, MS), 5 * MS, 0
            t += 20 * MS
            span = r.add("engine.dispatch", start, start + length, value)
            at = start
            for name, n in zip(("engine.tokenize", "engine.stage", "engine.replay"), parts):
                r.add(name, at, at + n, parent=span.id)
                at += n
        r.add("engine.fetch", t, t + (3 if window else 7) * MS)
    # one collection of 4 ms inside the window, one before it, one after
    r.add("python.gc", 1005 * MS, 1009 * MS, 0)
    r.add("python.gc", 10, 20, 2)
    r.add("python.gc", 10**7 * MS, 10**7 * MS + 1, 1)
    return r


def record(calls=2):
    return Record(cell=cell(), counts={"forwards": 4 * calls, "calls": calls})


def readings(rings, rec):
    with mock.patch.object(program_spans, "recorder", return_value=rings.spans):
        return {name: spec.reader(name)(rec) for name in NEW}


def test_the_window_is_taken_by_position():
    r = filled()
    got = readings(r, record())
    assert got["engine.tokenize_ms"] == pytest.approx(0.25)
    assert got["engine.stage_ms"] == pytest.approx(0.5)
    assert got["engine.replay_ms"] == pytest.approx(0.125)
    assert got["engine.fetch_ms_per_call"] == pytest.approx(3.0)
    assert got["engine.starved_share"] == pytest.approx(25.0)  # 2 of 8
    # 4 ms of collection in the window's 72 ms (first start to last end)
    assert got["host.gc_ms_per_s"] == pytest.approx(4.0 / 0.072)
    assert got["setup.weights_s"] == pytest.approx(3.0)
    assert got["setup.init_s"] == pytest.approx(0.8)
    assert got["setup.graphs_s"] == pytest.approx(3.0)  # 4 s less the build inside


def test_no_recorder_reads_nothing():
    rec = record()
    with mock.patch.object(program_spans, "recorder", return_value=None):
        assert {name: spec.reader(name)(rec) for name in NEW} == {n: None for n in NEW}


def test_the_parents_program_reads_nothing():
    """A program whose profiling module has no `spans` (the parent's)."""
    import types

    bare = types.ModuleType("vqa_tpu_torch.utils.profiling")
    with mock.patch.dict(sys.modules, {"vqa_tpu_torch.utils.profiling": bare}):
        import vqa_tpu_torch.utils as utils

        with mock.patch.object(utils, "profiling", bare, create=True):
            assert program_spans.recorder() is None
            rec = record()
            assert all(spec.reader(n)(rec) is None for n in NEW)


def test_too_few_records_read_nothing():
    r = filled(calls=2, trailing=0)
    got = readings(r, record(calls=3))  # the window claims a call the rings lack
    assert all(got[n] is None for n in DISPATCH + ["engine.fetch_ms_per_call"])
    assert all(got[n] is not None for n in SETUP)


def test_a_wrapped_ring_reads_nothing():
    r = filled()
    # the oldest records went, the window's first among them
    r.records["engine.dispatch"] = r.records["engine.dispatch"][13:]
    r.records["engine.fetch"] = r.records["engine.fetch"][4:]
    got = readings(r, record())
    assert all(got[n] is None for n in DISPATCH + ["engine.fetch_ms_per_call"])
    r = filled()
    r.records["engine.stage"] = r.records["engine.stage"][13:]
    assert readings(r, record())["engine.stage_ms"] is None
    r = filled()
    r.records["python.gc"] = r.records["python.gc"][2:]  # wrapped past the window's start
    assert readings(r, record())["host.gc_ms_per_s"] is None


def test_a_run_leaves_the_positions_the_readers_take(monkeypatch):
    """A tiny untraced run on the CPU, from empty rings: the dispatches are
    the warm-up's then the window's, one fetch a call, and every reader but
    the graphs' (the CPU engine captures none) reads a number."""
    import benchmark.run as run
    from vqa_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_rings", {})
    c = sound_limits(tiny_cell("ref_infer_b32"))
    with mock.patch("torch.cuda.get_device_name", return_value="cpu"):
        rec, line = run.measure(c, 2**31 + 5, 1.0, False, device="cpu")
    assert line["correct"] is True
    per_call = c.traffic["call_pairs"] // c.traffic["bucket"]
    assert profiling.spans("engine.dispatch")[1] == (
        c.traffic["warm_calls"] * per_call + rec.counts["forwards"])
    assert profiling.spans("engine.fetch")[1] == c.traffic["warm_calls"] + rec.counts["calls"]
    got = {name: spec.reader(name)(rec) for name in NEW}
    assert got.pop("setup.graphs_s") is None
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["engine.starved_share"] == 100.0  # the CPU is never behind
