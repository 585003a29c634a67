"""A run with its timed path broken underneath must come out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(`run.measure`) of a cell at a tiny width on the CPU, with a fault planted
where the engine produces its answers (`dispatch_probs_from_pixels`): an
answer altered, and
half of each batch left out (its rows answered with the other half's). The
same run without a fault comes out correct. The control (the reference in
fp8 in the program's place) fails the committed limits at this width too;
on the card, `test_control_on_the_card` reads it at the cell's own size.
"""

import os
import sys
from unittest import mock

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tiny import ROOT, sound_limits, tiny_cell  # noqa: E402

import benchmark.run as run  # noqa: E402
from benchmark.harness import spec  # noqa: E402

CELLS = ["ref_infer_b32", "noattn_infer_b32"]


def altered(probs, n):
    """The first row's best and worst answers swapped."""
    out = probs.clone()
    row = out[0]
    hi, lo = int(row.argmax()), int(row.argmin())
    row[hi], row[lo] = probs[0, lo], probs[0, hi]
    return out


def half_left_out(probs, n):
    """The second half of the rows answered with the first half's."""
    out = probs.clone()
    half = max(n // 2, 1)
    out[half:n] = probs[: n - half]
    return out


def drive(cell_name, fault=None):
    from vqa_tpu_torch.serving.engine import VQAInference

    cell = sound_limits(tiny_cell(cell_name))
    real = VQAInference.dispatch_probs_from_pixels

    def broken(self, pixels, questions):
        probs, n = real(self, pixels, questions)
        return fault(probs, n), n

    patches = [mock.patch("torch.cuda.get_device_name", return_value="cpu")]
    if fault is not None:
        patches.append(mock.patch.object(VQAInference, "dispatch_probs_from_pixels", broken))
    with patches[0]:
        if fault is not None:
            with patches[1]:
                rec, line = run.measure(cell, 2**31 + 17, 1.5, False, device="cpu")
        else:
            rec, line = run.measure(cell, 2**31 + 17, 1.5, False, device="cpu")
    return rec, line


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    rec, line = drive(cell)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [altered, half_left_out], ids=["altered", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_not_correct(cell, fault):
    rec, line = drive(cell, fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    c = tiny_cell(cell)
    readings = spec.kind(c.traffic["kind"]).control_readings(c, 2**31 + 23, "cpu")
    limits = sound_limits(c).traffic["limits"]
    assert any(readings[k] > limits[k] for k in readings), (readings, limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's own size there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    c = spec.load(ROOT, cell)
    readings = spec.kind(c.traffic["kind"]).control_readings(c, 2**31 + 29, "cuda")
    limits = c.traffic["limits"]
    assert any(readings[k] > limits[k] for k in readings), (readings, limits)
