"""The traced sub-window's reduction on a made-up event list (a CPU host
cannot record device activity), and the metric readers on it."""

import contextlib
import os
import sys
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tiny import tiny_cell  # noqa: E402

from benchmark.costs.flops import forward_flops  # noqa: E402
from benchmark.costs.peaks import BF16_FLOP_PER_S  # noqa: E402
from benchmark.harness import spec, trace  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402
from benchmark.harness.trace import WINDOW, Traced, breakdown, kernel_base, named  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def traced(events):
    t = Traced()
    t.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return t.summary()


def test_busy_idle_and_gaps():
    events = [
        Event(WINDOW, CPU, 0, 1000),
        Event("bench.call", CPU, 0, 550),
        Event("bench.dispatch", CPU, 0, 200),
        Event("bench.dispatch", CUDA, 0, 200),      # the annotation mirrored: not work
        Event("stem_kernel_bf16", CUDA, 100, 300),
        Event("se_bf16<4>", CUDA, 250, 400),        # overlaps the stem
        Event("Memcpy HtoD", CUDA, 600, 700),
        Event("late", CUDA, 950, 1100),             # clipped to the window
    ]
    s = traced(events)
    assert s["busy_s"] * 1e9 == 300 + 100 + 50
    assert s["window_s"] * 1e9 == 1000
    assert set(s["by_name"]) == {"stem_kernel_bf16", "se_bf16<4>", "Memcpy HtoD", "late"}
    # gaps (named at their middle): 0-100 under bench.dispatch, 400-600 under bench.call,
    # 700-950 under no annotation
    assert s["idle"] == {"idle: bench.dispatch": 100e-9, "idle: bench.call": 200e-9,
                         "idle: other host work": 250e-9}
    b = breakdown(s)
    assert b["device_ops"][0][0] in ("stem_kernel_bf16", "se_bf16<4>")
    assert len(b["idle_gaps"]) == 3 and named(s)
    other = {"idle: bench.call": 1.0}
    assert breakdown(s, other)["idle_gaps"] == [["idle: bench.call", 1.0]]


def test_no_device_work_reads_nothing():
    assert traced([Event(WINDOW, CPU, 0, 10), Event("bench.call", CPU, 0, 10)]) is None


FAMILIES = (("void (anonymous namespace)::stem_kernel_bf16(CUtensorMap const, unsigned short"
             " const*)", 1),
            ("void (anonymous namespace)::se_bf16((anonymous namespace)::Params)", 4),
            ("void (anonymous namespace)::cross_attention_bf16<32, 1>((anonymous namespace)"
             "::Args16)", 2),
            ("void at::native::elementwise_kernel<128, 4, at::native::direct_copy_kernel_cuda("
             "at::TensorIteratorBase&)::{lambda()#1}>(int, float)", 3))


def forward_events(forwards, extra=(), leave_out=(), window_ns=10_000_000):
    """A window of `forwards` bf16 forwards at the tiny width's kernel
    families, each launch 0.1 ms, one every 0.2 ms."""
    events = [Event(WINDOW, CPU, 0, window_ns)]
    t = 0
    for _ in range(forwards):
        for name, n in FAMILIES + tuple(extra):
            if any(k in name for k in leave_out):
                continue
            for _ in range(n):
                events.append(Event(name, CUDA, t, t + 100_000))
                t += 200_000
    return events


def bf16_cell():
    cell = tiny_cell("ref_infer_b32")
    cell.config["dtype"] = "bfloat16"
    return cell


def test_the_trace_readers():
    cell = bf16_cell()
    rec = Record(cell=cell, trace=traced(forward_events(4)), trace_counts={"forwards": 4},
                 counts={"pairs": 128, "forwards": 1000}, window_s=1.0)
    read = {m["name"]: spec.reader(m["name"]) for m in cell.per_layer}
    # 1 ms busy per forward in the trace, 1,000 forwards in the 1 s window
    assert abs(read["idle.infer"](rec) - 0.0) < 1e-9
    rec.counts["forwards"] = 400
    assert abs(read["idle.infer"](rec) - 60.0) < 1e-9
    assert abs(read["forward.device_ms"](rec) - 1.0) < 1e-9
    roof = read["kernels_roofline"](rec)
    assert 0 < roof < 100 and not rec.notes
    flops = forward_flops(cell.model)["total"] * cell.traffic["bucket"]
    assert abs(read["forward.mfu"](rec) - 100 * flops / (1e-3 * BF16_FLOP_PER_S)) < 1e-9
    rec.trace_counts["forwards"] = 5  # launches no longer per forward: nothing read
    assert read["kernels_roofline"](rec) is None
    assert "stem (4 launches" in rec.notes[-1]
    assert read["mfu.infer"](rec) > 0


def test_the_roofline_matches_kernel_names_whole():
    """Operations whose names hold a family's name (a transpose, a dense
    SE) are not the family's; a family missing from the trace reads
    nothing, with a note naming it."""
    cell = bf16_cell()
    read = spec.reader("kernels_roofline")
    base = Record(cell=cell, trace=traced(forward_events(4, window_ns=10**8)),
                  trace_counts={"forwards": 4})
    stray = (("void transpose_bf16<float>(float const*, float*)", 3),
             ("dense_se_bf16_kernel", 1), ("void se_bf16_tail(float*)", 2))
    rec = Record(cell=cell, trace=traced(forward_events(4, extra=stray, window_ns=10**8)),
                 trace_counts={"forwards": 4})
    assert read(rec) == read(base) and not rec.notes
    rec = Record(cell=cell, trace=traced(forward_events(4, leave_out=("se_bf16",))),
                 trace_counts={"forwards": 4})
    assert read(rec) is None
    assert rec.notes == ["kernels_roofline not read: se (0 launches of se_bf16, 16 expected)"]


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::se_bf16((anonymous namespace)::Params)", "se_bf16"),
    ("void (anonymous namespace)::cross_attention_bf16<32, 1>((anonymous namespace)::Args16)",
     "cross_attention_bf16"),
    ("stem_kernel_bf16", "stem_kernel_bf16"),
    ("void at::native::elementwise_kernel<128, 4, at::native::direct_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#1}>(int)", "elementwise_kernel"),
    ("void transpose_bf16<float>(float*)", "transpose_bf16"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pinned -> Device)"),
])
def test_kernel_base(name, base):
    assert kernel_base(name) == base


def test_without_its_annotation_the_window_takes_the_host_clock():
    t = Traced()
    t.host_s = 1e-6
    t.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: [Event("bench.call", CPU, 4000, 5500),
                        Event("graph_kernel", CUDA, 5000, 5300),
                        Event("Memcpy DtoH", CUDA, 5600, 5700)])))
    s = t.summary()
    assert s["window_s"] * 1e9 == 1000 and s["busy_s"] * 1e9 == 400
    assert s["idle"] == {"idle: bench.call": pytest.approx(300e-9),
                         "idle: other host work": pytest.approx(300e-9)}
    t.prof.profiler.kineto_results.events = lambda: [Event("graph_kernel", CUDA, 5000, 5300)]
    assert not named(t.summary())


def test_the_window_is_the_annotations():
    t = Traced()
    t.prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: [Event(WINDOW, CPU, 4000, 6000), Event("bench.call", CPU, 4000, 6000),
                        Event("graph_kernel", CUDA, 5000, 5300)])))
    s = t.summary()
    assert s["window_s"] * 1e9 == 2000
    assert s["idle"] == {"idle: bench.call": pytest.approx(1700e-9)}


def test_a_window_that_saw_no_device_work_is_profiled_again():
    sums = iter([None, None, {"idle": {}}])

    class Fake:
        def __init__(self, cpu):
            self.reason = "nothing"

        @contextlib.contextmanager
        def window(self):
            yield

        def summary(self):
            return next(sums)

    calls = []
    with mock.patch.object(trace, "Traced", Fake):
        summary, reason, out = trace.profiled(lambda: calls.append(1) or len(calls))
    assert summary == {"idle": {}} and out == 3
