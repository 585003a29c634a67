"""The port's profiling helpers (``vqa_tpu_torch/utils/profiling.py``): the
cases of ``tests/test_profiling.py`` on the CPU that the port keeps —
annotations outside a trace, the fenced step timer, the trace writers, and
``device_synthetic_inputs``'s shapes, dtypes and ranges (its values are
torch's draws, not JAX's PRNG bits). The span recorder is
``tests/test_torch_spans.py``'s.
"""

import glob
import json
import os

import pytest
import torch

from vqa_tpu_torch.utils import profiling
from vqa_tpu_torch.utils.profiling import (
    Profiler,
    StepTimer,
    annotate,
    device_synthetic_inputs,
    maybe_trace,
    percentile_summary,
    step_annotation,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_all_is_the_jax_list():
    """The port's own list: the JAX package's, less ``start_trace``,
    ``stop_trace`` and ``time_chained`` (no caller in the port), with the
    span recorder's ``spans`` and ``watch_gc``."""
    assert profiling.__all__ == [
        "annotate", "spans", "watch_gc", "step_annotation", "Profiler", "StepTimer",
        "percentile_summary", "device_synthetic_inputs"]


def test_annotations_are_safe_outside_a_trace():
    with annotate("region"):
        with step_annotation("step", 3):
            x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0


def test_step_timer_summarizes():
    x = torch.ones(64, 64)
    timer = StepTimer()
    for _ in range(5):
        with timer.step(items=32) as s:
            s.result = (x @ x).sum()
    out = timer.summary()
    assert out["count"] == 5 and out["p50_ms"] > 0 and out["p99_ms"] >= out["p50_ms"]
    assert out["items_per_sec"] > 0
    timer.reset()
    assert timer.summary() == {"count": 0}
    assert percentile_summary([]) == {"count": 0}


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with Profiler(logdir):
        with annotate("doubled"):
            (torch.ones(8) * 2).sum()
    dumped = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    assert dumped, "the profiler wrote no trace"
    assert "doubled" in _trace_names(os.path.join(logdir, "trace.json"))


def test_maybe_trace_none_is_a_noop(tmp_path):
    with maybe_trace(None):
        pass
    with maybe_trace(str(tmp_path / "t")):
        torch.ones(2).sum()
    assert os.path.exists(tmp_path / "t" / "trace.json")


def test_device_synthetic_inputs_shapes_dtypes_and_ranges():
    imgs, ids, mask, labels = device_synthetic_inputs(
        3, image_size=32, qlen=6, vocab_size=50, num_answers=9, device="cpu")
    assert imgs.shape == (3, 32, 32, 3) and imgs.dtype == torch.float32
    assert ids.shape == (3, 6) and ids.dtype == torch.int64
    assert int(ids.min()) >= 4 and int(ids.max()) < 50  # no special tokens
    assert mask.shape == (3, 6) and int(mask.min()) == 1
    assert labels.shape == (3,) and 0 <= int(labels.min()) and int(labels.max()) < 9
    assert all(t.device.type == "cpu" for t in (imgs, ids, mask, labels))

    u8, _, _, _ = device_synthetic_inputs(2, image_size=16, pixels="u8", device="cpu")
    assert u8.dtype == torch.uint8 and u8.shape == (2, 16, 16, 3)
    assert int(u8.max()) > 200  # spans 0..255

    a, *_ = device_synthetic_inputs(2, image_size=16, seed=0, device="cpu")
    b, *_ = device_synthetic_inputs(2, image_size=16, seed=1, device="cpu")
    again, *_ = device_synthetic_inputs(2, image_size=16, seed=0, device="cpu")
    assert float((a - b).abs().max()) > 0 and torch.equal(a, again)
    with pytest.raises(ValueError, match="pixels"):
        device_synthetic_inputs(1, pixels="f16", device="cpu")


def test_device_synthetic_inputs_default_to_the_card():
    """Without a device the inputs go to the card, and without a card that
    raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        assert device_synthetic_inputs(1, image_size=8)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_synthetic_inputs(1, image_size=8)

