"""Nothing the benchmark runs imports JAX or the JAX package: by a scan of
the benchmark's sources and by the modules a process holds after importing
every one of them. Top-level names are compared whole: the port's own
name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from perfbench.core import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "deepfm_tpu"}
BENCH = os.path.join(registry.ROOT, "perfbench")


def _sources():
    for dirpath, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & FORBIDDEN, (path, tops)


def test_importing_every_module_loads_no_jax():
    code = (
        "import sys, os, importlib.util\n"
        f"sys.path.insert(0, {registry.ROOT!r})\n"
        "import perfbench.run, perfbench.calibrate\n"
        "from perfbench.core import process, registry\n"
        "for kind, load in (('metrics', registry.metric),\n"
        "                   ('kernels', registry.kernel),\n"
        "                   ('families', registry.family)):\n"
        f"    for n in os.listdir(os.path.join({BENCH!r}, kind)):\n"
        "        if n.endswith('.py') and n != '__init__.py':\n"
        "            load(n[:-3])\n"
        "import deepfm_tpu_torch.train.loop\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device (this host): exit other than 0, no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "deepfm_criteo.train.uniform", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=registry.ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark: exit
    other than 0, no result line."""
    import shutil
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "deepfm_criteo.train.uniform", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()
