"""Tiny cells for the CPU tests: a cell of BENCHMARK.json with the model cut
to a tiny width in float32 and its traffic cut to a few requests."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402

TINY_MODEL = dict(image_size=64, base_channels=8, stage_channels=[8, 16, 32, 64],
                  feature_spatial_size=2, se_reduction=4, vocab_size=400, embed_dim=32,
                  num_transformer_layers=1, num_attention_heads=2, ffn_hidden_dim=64,
                  max_question_length=10, num_answers=64, answer_hidden_dim=64)
TINY_TRAFFIC = {
    "infer_pixels": dict(pool_pairs=64, call_pairs=16, bucket=4, check_rows=48,
                         trace_seconds=0.2),
}


def tiny_cell(name: str) -> spec.Cell:
    cell = copy.deepcopy(spec.load(ROOT, name))
    cell.config["dtype"] = "float32"
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


def sound_limits(cell: spec.Cell) -> spec.Cell:
    """The committed limits where they are set, else ones a sound float32 run
    at this width meets (its gaps are rounding, ~1e-6)."""
    cell.traffic["limits"] = {k: (1e-3 if v is None else v)
                              for k, v in cell.traffic["limits"].items()}
    return cell
