"""moe.router_ms on made-up traces (a CPU host cannot record device
activity): read where both router kernels launched once per MoE layer per
forward, a note and no reading otherwise; the kernels' names match none of
the routed path's, so moe.experts_ms reads what it read before."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.costs.decoder_flops import GROUPED_GEMM, ROUTED_KERNELS, ROUTED_SWIGLU  # noqa: E402
from benchmark.harness import spec  # noqa: E402
from benchmark.harness.record import Record  # noqa: E402
from benchmark.harness.trace import kernel_base  # noqa: E402

CELL = "kimivl_infer_b256"
ROUTE = "void (anonymous namespace)::moe_route_bf16<32>((anonymous namespace)::RouteParams)"
PLAN = "(anonymous namespace)::moe_plan(int const*, int, int, int, int, int*, int*, int*, int*)"


def record(route, plan, forwards=4):
    cell = spec.load(ROOT, CELL)
    trace = {"by_name": {ROUTE: 0.004, PLAN: 0.0004, "nvjet_tst_192x192": 0.3},
             "launches": {ROUTE: route, PLAN: plan, "nvjet_tst_192x192": 500}}
    return Record(cell=cell, trace=trace if route is not None else None,
                  trace_counts={"forwards": forwards})


def test_the_cell_reports_it_and_only_that_cell():
    assert "moe.router_ms" in [m["name"] for m in spec.load(ROOT, CELL).per_layer]
    for other in ("ref_infer_b32", "noattn_infer_b32"):
        assert "moe.router_ms" not in [m["name"] for m in spec.load(ROOT, other).per_layer]


def test_read_per_forward_where_each_moe_layer_launched_both():
    rec = record(26 * 4, 26 * 4)
    assert spec.reader("moe.router_ms")(rec) == pytest.approx(1.1)  # 4.4 ms over 4 forwards
    assert not rec.notes


@pytest.mark.parametrize("route,plan", [(0, 0), (26 * 4, 0), (26 * 4 - 1, 26 * 4),
                                        (26 * 8, 26 * 4)])
def test_not_read_with_a_note_where_a_count_is_off(route, plan):
    rec = record(route, plan)
    assert spec.reader("moe.router_ms")(rec) is None
    off = [f"{name} ({n} launches, 104 expected)"
           for name, n in (("moe_route_bf16", route), ("moe_plan", plan)) if n != 104]
    assert rec.notes == ["moe.router_ms not read: " + "; ".join(off)]


def test_not_read_without_a_trace():
    rec = record(None, None)
    assert spec.reader("moe.router_ms")(rec) is None and not rec.notes


def test_the_router_kernels_are_not_the_routed_paths():
    """moe.experts_ms keeps reading the permute, GEMMs, SwiGLU and unpermute."""
    for name in (ROUTE, PLAN):
        assert kernel_base(name) not in ROUTED_KERNELS
        assert ROUTED_SWIGLU[0] not in name
        assert not all(mark in name for mark in GROUPED_GEMM[0])
    assert {kernel_base(ROUTE), kernel_base(PLAN)} == {"moe_route_bf16", "moe_plan"}
