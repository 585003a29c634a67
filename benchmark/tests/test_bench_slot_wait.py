"""`engine.slot_wait_share` on a hand-filled recorder (the rings of
`test_bench_spans.py`): the window's `engine.stage` values read by their
dispatch, and None where the program's phases carry no value (a program
without landing slots), where it holds fewer records than the window and
where the ring has wrapped past it. Last, a tiny run on the CPU, whose
eager engine never waits for a slot."""

import os
import sys
import types
from unittest import mock

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_bench_spans import filled, record  # noqa: E402
from tiny import sound_limits, tiny_cell  # noqa: E402

from benchmark.harness import program_spans, spec  # noqa: E402

NAME = "engine.slot_wait_share"


def held(rings, every):
    """Set the value of every `every`-th `engine.stage` record to 1."""
    for i, r in enumerate(rings.records["engine.stage"]):
        r.value = int(i % every == 0)
    return rings


def read(rings, rec, annotate=None):
    from vqa_tpu_torch.utils import profiling

    with mock.patch.object(program_spans, "recorder", return_value=rings.spans), \
            mock.patch.object(profiling, "annotate", annotate or profiling.annotate):
        return spec.reader(NAME)(rec)


@pytest.mark.parametrize("case", ["window", "no_values", "too_few", "wrapped", "cpu_run"])
def test_slot_wait_share(case, monkeypatch):
    if case == "window":  # 2 calls of 4 dispatches; stages 0, 2, 4, ... held
        r = held(filled(), 2)
        # the window's first stage is the 13th record (3 warm calls of 4)
        assert read(r, record()) == pytest.approx(50.0)
        assert read(held(filled(), 4), record()) == pytest.approx(25.0)
        assert read(filled(), record()) == 0.0
    elif case == "no_values":  # the recorder of a program without landing slots
        assert read(held(filled(), 2), record(), annotate=types.new_class("annotate")) is None
    elif case == "too_few":
        assert read(held(filled(calls=2, trailing=0), 2), record(calls=3)) is None
    elif case == "wrapped":
        r = held(filled(), 2)
        r.records["engine.stage"] = r.records["engine.stage"][13:]
        assert read(r, record()) is None
    else:
        import benchmark.run as run
        from vqa_tpu_torch.utils import profiling

        monkeypatch.setattr(profiling, "_rings", {})
        c = sound_limits(tiny_cell("ref_infer_b32"))
        with mock.patch("torch.cuda.get_device_name", return_value="cpu"):
            rec, line = run.measure(c, 2**31 + 7, 0.5, False, device="cpu")
        assert line["correct"] is True
        assert spec.reader(NAME)(rec) == 0.0
