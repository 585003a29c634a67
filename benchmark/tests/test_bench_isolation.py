"""What the benchmark imports, and a run without a card."""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "vqa_tpu"}


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def sources(directory):
    for base, _, files in os.walk(directory):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        tops = imported_tops(path)
        assert tops <= {"__future__", "io", "math", "re", "collections", "typing", "numpy",
                        "torch"}, (path, tops)


def test_what_a_run_loads_holds_no_jax(tmp_path):
    """Everything run.py reaches: a whole run of each cell at a tiny width
    on the CPU, then the modules loaded, compared by whole top-level name."""
    script = f"""
import sys, json
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(BENCH, "tests")!r})
from tiny import tiny_cell, sound_limits
import benchmark.run as run
from unittest import mock
for cell in ("ref_infer_b32", "noattn_infer_b32"):
    c = sound_limits(tiny_cell(cell))
    with mock.patch("torch.cuda.get_device_name", return_value="cpu"):
        run.measure(c, 2**31 + 3, 1.0, False, device="cpu")
print("FOUND", json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "ref_infer_b32", "--seed", "4294967311", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs 1 CUDA card" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_a_run_from_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ref_infer_b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
