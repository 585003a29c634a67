"""attn.device_ms on made-up traces (a CPU host cannot record device
activity): read where the attention kernel launched once per decoder layer
per forward, a note and no reading otherwise."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402

CELL = "kimivl_infer_b256"
KERNEL = ("void (anonymous namespace)::mla_attention_bf16<128, 64, 128>"
          "((anonymous namespace)::Params)")


def record(launches, forwards=4, seconds=0.02):
    cell = spec.load(ROOT, CELL)
    trace = {"by_name": {KERNEL: seconds, "nvjet_tst_192x192": 0.3},
             "launches": {KERNEL: launches, "nvjet_tst_192x192": 500}}
    return Record(cell=cell, trace=trace if launches is not None else None,
                  trace_counts={"forwards": forwards})


def test_the_cell_reports_it_and_only_that_cell():
    assert "attn.device_ms" in [m["name"] for m in spec.load(ROOT, CELL).per_layer]
    for other in ("ref_infer_b32", "noattn_infer_b32"):
        assert "attn.device_ms" not in [m["name"] for m in spec.load(ROOT, other).per_layer]


def test_read_per_forward_where_each_layer_launched_it():
    rec = record(27 * 4)
    assert spec.reader("attn.device_ms")(rec) == pytest.approx(5.0)  # 20 ms over 4 forwards
    assert not rec.notes


@pytest.mark.parametrize("launches", [0, 27 * 4 - 1, 27 * 8])
def test_not_read_with_a_note_where_the_count_is_off(launches):
    rec = record(launches)
    assert spec.reader("attn.device_ms")(rec) is None
    assert rec.notes == [f"attn.device_ms not read: mla_attention_bf16 ({launches} launches, "
                         f"108 expected)"]


def test_not_read_without_a_trace():
    rec = record(None)
    assert spec.reader("attn.device_ms")(rec) is None and not rec.notes
