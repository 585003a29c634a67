"""``vqa_tpu_torch/tools/roofline.py`` against ``scripts/roofline.py``.

At the same arguments, with only the peaks swapped (the JAX script's
defaults are the v5e's; it is run here at the H100's), every per-stage
FLOP and byte count, every time, the totals and both floors print the same
in bf16, the JAX script's element size. f32 doubles every activation byte
and keeps the uint8 pixels and the f32 optimizer traffic. The module's
geometry is the full-width ``ModelConfig()``'s, and it writes a file only
with ``--out``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from vqa_tpu_torch.tools import roofline
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse(text: str) -> dict:
    """Each table row's numbers and bound, the totals and the floors."""
    out = {}
    for line in text.splitlines():
        name = line[:14].strip()
        if line.startswith(("additive floor", "perfect-overlap floor", "measured:")):
            out[line.split(" (")[0].split(":")[0]] = line.split(":", 1)[1].split()[:5]
        elif name and not line.startswith(("==", "component", "-")):
            fields = line[14:].split()
            bound = {"mxu": "ops"}.get(fields[-1], fields[-1]) if name != "TOTAL" else None
            out[name] = (fields[:-1] if bound else fields, bound)
    return out


def _run(argv) -> str:
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("batch", [32, 256, 1024])
def test_counts_match_the_jax_script(train, batch):
    flags = ["--batch", str(batch), "--measured-pairs-per-sec", "2500"] + (
        ["--train"] if train else [])
    jax = _parse(_run(["scripts/roofline.py", *flags, "--peak-tflops", "989",
                       "--hbm-gbps", "3350"]))
    port = _parse(_run(["-m", "vqa_tpu_torch.tools.roofline", *flags]))
    assert port == jax
    names = [r["name"] for r in roofline.rows(batch, train)]
    assert names == [n for n in jax if n not in ("TOTAL", "additive floor",
                                                 "perfect-overlap floor", "measured")]


def test_rows_and_floors_are_what_the_table_prints():
    table = roofline.rows(32, False, "bf16")
    fl = roofline.floors(table, 989.0)
    printed = _parse(roofline.report(table, False, 32, 989.0, 3350.0))
    assert printed["TOTAL"][0][:2] == [f"{fl['flops'] / 1e9:.3f}", f"{fl['bytes'] / 1e6:.2f}"]
    assert printed["perfect-overlap floor"][0] == f"{fl['overlap_us']:.1f}"
    floor = roofline.forward_floor_ms(32, "bf16")
    assert floor["overlap_ms"] == pytest.approx(fl["overlap_us"] * 32 / 1e3)
    assert floor["bound_by"] == "operations"


@pytest.mark.parametrize("train", [False, True])
def test_f32_doubles_the_activation_bytes(train):
    b16 = {r["name"]: r for r in roofline.rows(256, train, "bf16")}
    b32 = {r["name"]: r for r in roofline.rows(256, train, "f32")}
    pixels = 224 * 224 * 3
    for name, r in b16.items():
        assert b32[name]["flops"] == r["flops"] and b32[name]["bwd_flops"] == r["bwd_flops"]
        if name == "grads+AdamW":
            assert b32[name]["bwd_bytes"] == r["bwd_bytes"]
            continue
        own = pixels if name == "stem conv" else 0
        assert b32[name]["bytes"] - own == 2 * (r["bytes"] - own)
        assert b32[name]["bwd_bytes"] == 2 * r["bwd_bytes"]
    f32 = roofline.forward_floor_ms(32, "f32")
    assert f32["bound_by"] == "operations"
    assert f32["overlap_ms"] > roofline.forward_floor_ms(32, "bf16")["overlap_ms"]


def test_the_geometry_is_the_full_width_model_config():
    from vqa_tpu_torch.models import count_parameters, create_vqa_model
    from vqa_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig()
    assert roofline.IMAGE == cfg.image_size
    assert [c for _, _, c in roofline.STAGES] == list(cfg.stage_channels)
    assert roofline.STAGES[-1][0] == cfg.feature_spatial_size
    assert roofline.IMAGE_TOKENS == cfg.feature_spatial_size ** 2
    assert (roofline.EMBED, roofline.TOKENS, roofline.FFN, roofline.TEXT_LAYERS,
            roofline.ANSWERS) == (cfg.embed_dim, cfg.max_question_length, cfg.ffn_hidden_dim,
                                  cfg.num_transformer_layers, cfg.num_answers)
    model = create_vqa_model(config=cfg, device="cpu")
    assert count_parameters(model)["total"] == roofline.N_PARAMS


def test_writes_a_file_only_with_out(tmp_path):
    before = set(os.listdir(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "vqa_tpu_torch.tools.roofline", "--dtype",
                           "f32", "--batch", "32"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert set(os.listdir(tmp_path)) == before
    out = tmp_path / "roofline.json"
    assert roofline.main(["--dtype", "f32", "--batch", "32", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["peak_tflops"] == 67.0 and data["hbm_gbps"] == 3350.0
    assert data["floors"] == roofline.floors(roofline.rows(32, False, "f32"), 67.0)
