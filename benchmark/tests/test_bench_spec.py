"""BENCHMARK.json, the configuration and traffic files, and what the harness
finds by name."""

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness import spec  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_the_contract():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = set()
    for section, allowed in keys.items():
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert allowed <= set(e) <= allowed | extra, (section, e["name"])
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for text in ("why", "layer", "source"):
                if text in e and isinstance(e[text], str):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        c = spec.load(ROOT, cell)
        assert len(c.end_to_end) >= 2 and "setup_s" in {m["name"] for m in c.end_to_end}
        assert c.per_layer
        assert c.chips == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    from vqa_tpu_torch.models.vqa_model import VQAModel, count_parameters
    from vqa_tpu_torch.utils.config import model_config_from_dict

    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == [] and cfg["assumed"] == []
    assert cfg["dtype"] == "bfloat16"
    model = VQAModel(model_config_from_dict(cfg["model"]))
    assert count_parameters(model)["total"] == cfg["parameters"]
    assert entry["file"].startswith("benchmark/")


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_each_piece_by_name(cell):
    c = spec.load(ROOT, cell)
    kind = spec.kind(c.traffic["kind"])
    assert callable(kind.run) and callable(kind.control_readings)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_metric_and_traffic_file_has_its_piece():
    """Every metric of BENCHMARK.json has its reader and every traffic mix a
    generator, and every reader and mix is some cell's."""
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "metrics"))
             if f.endswith(".py")}
    assert metrics == files
    traffic = {f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "traffic"))}
    assert traffic == {w["traffic"] for w in BENCH["workloads"]}
    for t in traffic:
        with open(os.path.join(ROOT, "benchmark", "traffic", t + ".json")) as f:
            assert callable(spec.kind(json.load(f)["kind"]).run)


def test_the_harness_names_no_cell_config_or_metric():
    names = set(CELLS) | {c["name"] for c in BENCH["configs"]} | {
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} | {
        w["traffic"] for w in BENCH["workloads"]}
    code = ""
    for d in ("harness", "kinds"):
        for f in os.listdir(os.path.join(ROOT, "benchmark", d)):
            if f.endswith(".py"):
                with open(os.path.join(ROOT, "benchmark", d, f)) as fh:
                    code += fh.read()
    with open(os.path.join(ROOT, "benchmark", "run.py")) as fh:
        code += fh.read()
    assert not [n for n in names if re.search(r"[\"']" + re.escape(n) + r"[\"']", code)]
