"""What one run measures, found by name.

`load(root, workload)` reads `BENCHMARK.json` at the checkout's root and
returns the cell: its entry, its configuration (the file the entry's
`config` names), its traffic mix (`benchmark/traffic/<traffic>.json`, whose
`kind` names the generator `benchmark/kinds/<kind>.py`) and the metrics it
reports: the end-to-end and the per-layer metrics whose `workloads` list
it, or that have no such list. Each metric is read by
`benchmark/metrics/<name>.py` (`read(record) -> float | None`).

Nothing here names a cell, a configuration, a traffic mix or a metric: a
later change adds one as files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file as committed
    traffic_name: str
    traffic: dict         # the traffic mix's parameters
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def dtype(self) -> str:
        return self.config["dtype"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(entries)})")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = compose(w["config"], w["traffic"], workload, os.path.join(root, cfg_entry["file"]))
    cell.chips = w["chips"]
    cell.end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
    cell.per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return cell


def compose(config: str, traffic: str, name: str = "", config_file: str = "") -> Cell:
    """A configuration under a traffic mix, with no metrics: what the
    calibration tool `control.py` runs, a cell or not."""
    path = config_file or os.path.join(HERE, "configs", config + ".json")
    with open(path) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    return Cell(name=name or f"{config}.{traffic}", chips=1, config_name=config, config=cfg,
                traffic_name=traffic, traffic=mix)


def kind(name: str):
    """The traffic generator module `benchmark/kinds/<name>.py`."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str) -> Callable:
    """`read` of `benchmark/metrics/<metric>.py` (metric names hold dots, so
    the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in metrics}
