"""The port stands alone: it imports no jax, flax or vqa_tpu, and no
library kernel stands in for one of its own.

``chip_smoke.py`` may time ``scaled_dot_product_attention`` as the
yardstick of the cross-attention kernel; the package never calls it.
"""

import ast
import os
import subprocess
import sys

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vqa_tpu_torch")
FORBIDDEN_IMPORTS = ("jax", "flax", "vqa_tpu", "optax", "orbax", "tensorstore", "zstandard")


def _port_files():
    """(path, whether SDPA is forbidden there)."""
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f), True
    yield os.path.join(REPO, "chip_smoke.py"), False


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vqa_tpu_torch\n"
        "for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, 'vqa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "print(len([n for n in sys.modules if n.startswith('vqa_tpu_torch.')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every submodule was imported


def test_no_forbidden_import_or_library_kernel_in_the_source():
    found = []
    for path, no_sdpa in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                names += [a.name for a in node.names if node.module == "torch"]
            else:
                names = []
            found += [(path, n) for n in names
                      if n.split(".")[0] in FORBIDDEN_IMPORTS or n == "compile"]
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else None)
            if no_sdpa and name == "scaled_dot_product_attention":
                found.append((path, name))
            if (isinstance(node, ast.Attribute) and node.attr == "compile"
                    and isinstance(node.value, ast.Name) and node.value.id == "torch"):
                found.append((path, "torch.compile"))
    assert not found, found


def test_the_evaluator_and_the_dtype_layers_import_no_jax():
    """The modules of the bf16 policy and the evaluator, each alone in a
    fresh interpreter."""
    code = (
        "import sys\n"
        "import vqa_tpu_torch.models.layers, vqa_tpu_torch.training.evaluate as ev\n"
        "ev.parse_args(['--checkpoint-dir', 'x', '--bf16'])\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_parallel_package_imports_without_jax_a_card_or_a_group():
    """``vqa_tpu_torch.parallel`` alone in a fresh interpreter that sees no
    card and joins no process group: the single-process answers."""
    code = (
        "import sys, torch\n"
        "import vqa_tpu_torch.parallel as parallel\n"
        "assert not torch.cuda.is_available() and not torch.distributed.is_initialized()\n"
        "assert parallel.mesh_from_config().shape == {'data': 1, 'model': 1}\n"
        "assert parallel.distributed.initialize() is False\n"
        "assert not torch.distributed.is_initialized()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_resampler_and_the_tools_import_no_jax():
    """The native binding (built and loaded here), the attention analysis,
    profiling and the four tools, each in a fresh interpreter, and the
    package walk reaches every one of them."""
    modules = ["vqa_tpu_torch.native", "vqa_tpu_torch.utils.attention_analysis",
               "vqa_tpu_torch.utils.profiling", "vqa_tpu_torch.tools.make_vqa_corpus",
               "vqa_tpu_torch.tools.attention_faithfulness",
               "vqa_tpu_torch.tools.visualize_attention", "vqa_tpu_torch.tools.soak_test"]
    code = (
        "import importlib, pkgutil, sys\n"
        "import vqa_tpu_torch\n"
        f"wanted = {modules!r}\n"
        "for name in wanted:\n"
        "    importlib.import_module(name)\n"
        "from vqa_tpu_torch import native\n"
        "native.available()\n"
        "walked = {m.name for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, "
        "'vqa_tpu_torch.')}\n"
        "assert set(wanted) <= walked, set(wanted) - walked\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_engine_graphs_and_the_roofline_import_no_jax():
    """``serving/graphs.py`` and ``tools/roofline.py``, each alone in a
    fresh interpreter; the roofline imports no torch either (counts only),
    and the package walk reaches both."""
    modules = ["vqa_tpu_torch.serving.graphs", "vqa_tpu_torch.tools.roofline"]
    code = (
        "import importlib, pkgutil, sys\n"
        "import vqa_tpu_torch.tools.roofline\n"
        "assert 'torch' not in sys.modules, 'the roofline imported torch'\n"
        "import vqa_tpu_torch\n"
        f"wanted = {modules!r}\n"
        "for name in wanted:\n"
        "    importlib.import_module(name)\n"
        "walked = {m.name for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, "
        "'vqa_tpu_torch.')}\n"
        "assert set(wanted) <= walked, set(wanted) - walked\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_train_graphs_and_the_ablation_runner_import_no_jax():
    """``training/step_graph.py``, ``utils/graphs.py`` and
    ``tools/run_ablation.py`` in a fresh interpreter; the ablation runner
    imports no torch either (its work runs in subprocesses), never imports
    the JAX script it ports, and the package walk reaches all three."""
    modules = ["vqa_tpu_torch.training.step_graph", "vqa_tpu_torch.utils.graphs",
               "vqa_tpu_torch.tools.run_ablation"]
    code = (
        "import importlib, pkgutil, sys\n"
        "import vqa_tpu_torch.tools.run_ablation\n"
        "assert 'torch' not in sys.modules, 'the ablation runner imported torch'\n"
        "assert not any('run_ablation' in n and not n.startswith('vqa_tpu_torch.') "
        "for n in sys.modules)\n"
        "import vqa_tpu_torch\n"
        f"wanted = {modules!r}\n"
        "for name in wanted:\n"
        "    importlib.import_module(name)\n"
        "walked = {m.name for m in pkgutil.walk_packages(vqa_tpu_torch.__path__, "
        "'vqa_tpu_torch.')}\n"
        "assert set(wanted) <= walked, set(wanted) - walked\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_on_card_checks_import_the_package_and_nothing_imports_chip_smoke():
    """The arrows point one way: ``chip_smoke.py``, the ``cuda`` tests and
    the tools share ``vqa_tpu_torch/testing.py``. No file under
    ``vqa_tpu_torch/`` or ``tests/`` imports the root script; no package
    module puts a repository root on ``sys.path`` (only ``stem_sweep.py
    --repo`` puts another checkout's there); and ``vqa_tpu_torch.testing``
    imports in a fresh interpreter without jax, ``vqa_tpu`` or torch, so a
    tool can load it by path beside another checkout's package."""
    found = []
    for top in (PKG, os.path.join(REPO, "tests")):
        for root, _, files in os.walk(top):
            for f in files:
                if not f.endswith(".py"):
                    continue
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    source = fh.read()
                for node in ast.walk(ast.parse(source, path)):
                    if isinstance(node, ast.Import):
                        names = [a.name for a in node.names]
                    elif isinstance(node, ast.ImportFrom):
                        names = [node.module or ""]
                    else:
                        names = []
                    found += [(path, n) for n in names if n.split(".")[0] == "chip_smoke"]
                    if (top == PKG and isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr in ("insert", "append")
                            and ast.unparse(node.func.value) == "sys.path"
                            and "args.repo" not in ast.unparse(node)):
                        found.append((path, ast.unparse(node)))
    assert not found, found

    code = (
        "import sys\n"
        "import vqa_tpu_torch.testing as t\n"
        "assert t.time_ms and t.bf16_compare and t.write_trainer_tree\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN_IMPORTS + ('torch',)!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
