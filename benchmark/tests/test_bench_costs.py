"""The benchmark's operation counts against PyTorch's own counter, and its
kernel bounds against the figures `chip_smoke.py` has printed."""

import json
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.costs.flops import forward_flops  # noqa: E402
from benchmark.costs.kernels import forward_bounds  # noqa: E402
from benchmark.harness import weights  # noqa: E402
from benchmark.reference.model import Reference  # noqa: E402


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("name", ["vqa_ref", "vqa_ref_noattn"])
def test_forward_flops_match_the_flop_counter(name):
    """Every product of the reference's full-width forward, as
    FlopCounterMode counts them (convolutions, linear layers, attention
    matmuls); the parts the count leaves out are not products."""
    cfg = config(name)
    state = weights.make_state(cfg, 7, "cpu")
    s = cfg["image_size"]
    pixels = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    ids = torch.randint(4, 100, (2, cfg["max_question_length"]))
    mask = torch.ones_like(ids)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        Reference(cfg, state).logits(pixels, ids, mask)
    assert counter.get_total_flops() == 2 * forward_flops(cfg)["total"]


def test_the_ablation_counts_no_se_or_spatial_attention():
    full, ablated = forward_flops(config("vqa_ref")), forward_flops(config("vqa_ref_noattn"))
    assert not [k for k in ablated if k.endswith((".se", ".spatial"))]
    left_out = sum(v for k, v in full.items() if k.endswith((".se", ".spatial")))
    assert full["total"] - ablated["total"] == left_out > 0
    # the roofline tool's figure for the full width, activations aside
    assert abs(full["total"] / 1e9 - 3.86) < 0.05


def test_kernel_bounds_are_chip_smokes():
    """bf16 bounds at bucket 32 as `chip_smoke.py` printed them (PERF.md's
    kernel table: stem 0.0076 ms, SE 0.0144, cross-attention 0.0016)."""
    b = forward_bounds(config("vqa_ref"), 32, "bfloat16")
    assert round(b["stem"]["bound_s"] * 1e3, 4) == 0.0076
    assert round(b["se"]["bound_s"] * 1e3, 4) == 0.0144
    assert round(b["cross_attention"]["bound_s"] * 1e3, 4) == 0.0016
    f = forward_bounds(config("vqa_ref"), 32, "float32")
    assert round(f["stem"]["bound_s"] * 1e3, 4) == 0.0458
    assert round(f["se"]["bound_s"] * 1e3, 4) == 0.0288
    assert round(f["cross_attention"]["bound_s"] * 1e3, 4) == 0.0033
    assert "se" not in forward_bounds(config("vqa_ref_noattn"), 32, "bfloat16")
