"""The port stands alone: ``deepfm_tpu_torch`` and ``chip_smoke.py`` import
neither jax, orbax nor anything of ``deepfm_tpu``.

Two checks: every module imports in a fresh interpreter where those
packages are made unimportable, and an AST scan finds no import of them
anywhere in the port's sources (including imports inside functions, which
the first check cannot reach).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepfm_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "orbax", "flax", "optax", "deepfm_tpu"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
        if rel[-1] == "__init__":
            rel = rel[:-1]
        mods.append(".".join(rel))
    return mods


def test_every_module_imports_without_jax():
    script = "\n".join([
        "import sys",
        *[f"sys.modules[{name!r}] = None" for name in sorted(FORBIDDEN)],
        "import importlib",
        f"for m in {_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "assert not any(m.split('.')[0] in " + repr(FORBIDDEN)
        + " for m in sys.modules if sys.modules[m] is not None)",
        "print('imported', len(" + repr(_modules()) + "))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(_modules())}" in res.stdout


@pytest.mark.parametrize("module", [
    "deepfm_tpu_torch.utils.preempt", "deepfm_tpu_torch.utils.faults",
    "deepfm_tpu_torch.train.guard", "deepfm_tpu_torch.train.state",
    "deepfm_tpu_torch.train.loop", "deepfm_tpu_torch.train.tasks",
    "deepfm_tpu_torch.launch", "deepfm_tpu_torch.native.loader",
    "deepfm_tpu_torch.data.health", "deepfm_tpu_torch.data.cache",
    "deepfm_tpu_torch.data.fileio", "deepfm_tpu_torch.utils.retry",
    "deepfm_tpu_torch.utils.profiling", "deepfm_tpu_torch.data.pipeline",
    "deepfm_tpu_torch.data.stream", "deepfm_tpu_torch.data.shm_ring",
    "deepfm_tpu_torch.data.workers", "deepfm_tpu_torch.train.publish",
    "deepfm_tpu_torch.train.metrics", "deepfm_tpu_torch.utils.checkpoint",
    "deepfm_tpu_torch.utils.export", "deepfm_tpu_torch.obs.tensorboard",
    "deepfm_tpu_torch.models.graph", "deepfm_tpu_torch.models.widedeep",
    "deepfm_tpu_torch.models.dcnv2", "deepfm_tpu_torch.models.multitask",
    "deepfm_tpu_torch.models.sequence", "deepfm_tpu_torch.ops.fm",
    "deepfm_tpu_torch.data.example_codec", "deepfm_tpu_torch.data.libsvm",
    "deepfm_tpu_torch.utils.params", "deepfm_tpu_torch.models.twin_tower",
    "deepfm_tpu_torch.rec", "deepfm_tpu_torch.rec.index",
    "deepfm_tpu_torch.rec.cascade", "deepfm_tpu_torch.parallel.bootstrap",
    "deepfm_tpu_torch.parallel.mesh", "deepfm_tpu_torch.fanout",
    "deepfm_tpu_torch.data.sharding", "deepfm_tpu_torch.utils.logging",
    "deepfm_tpu_torch.ops.embedding", "deepfm_tpu_torch.ops.embedding_kernels",
    "deepfm_tpu_torch.models.common", "deepfm_tpu_torch.train.optimizers"])
def test_module_list_covers_the_runtime_modules(module):
    """The fit loop's runtime (the staging ring, the guard and its state
    snapshot, preemption and its fault seams), the input path (the native
    decoder's loader, data health, the decoded cache, file I/O, read
    retries, the shard stream and the input service), the online
    trainer's pieces (the publisher, the windowed AUC, async checkpoints,
    the pointer history, TensorBoard) and the model zoo (the single-task
    graphs, the multi-task heads, the sequence models and their masked
    softmax, the two-label and history codec and generator, the weight
    carry-over), retrieval (the twin tower, the candidate index, the
    cascade), data parallelism (the bootstrap, the data axis, the
    fan-out launcher, the shard policy, rank-aware logging) and the model
    axis (the row-sharded lookups and the row exchange, the embedding
    schema, the lazy Adam over a shard) are among the modules the first
    check imports without jax."""
    assert module in _modules()


def test_worker_import_chain_leaves_torch_out():
    """A spawned input worker imports ``data.workers``: that chain (the
    pipeline, the native loader, data health, obs, retries, the config and
    the package's ``__init__``) must not import torch, which would cost
    seconds a spawn and could touch the card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, deepfm_tpu_torch.data.workers; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] == "
         "'torch'))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_input_path_loads_nothing_from_the_jax_package(tmp_path):
    """Build the decoder and run the pooled pipeline, the decoded cache and
    the retrying reader in a fresh interpreter where jax is unimportable:
    no module and no C++ source or library comes from ``deepfm_tpu/``."""
    script = "\n".join([
        "import sys",
        *[f"sys.modules[{name!r}] = None" for name in sorted(FORBIDDEN)],
        "from deepfm_tpu_torch.data import libsvm, pipeline",
        "from deepfm_tpu_torch.native import loader",
        f"files = libsvm.generate_synthetic_ctr({str(tmp_path)!r}, "
        "num_files=2, examples_per_file=50, feature_size=100, "
        "field_size=4, seed=1)",
        "p = pipeline.CtrPipeline(files, field_size=4, batch_size=8, "
        "decoded_cache='ram')",
        "n = sum(len(b['label']) for b in p)",
        "print('records', n)",
        "print('source', loader.SOURCE)",
        "print('library', loader._lib._name)",
        "print('modules', sorted({getattr(m, '__file__', None) or '' "
        "for m in list(sys.modules.values()) if m is not None}))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = dict(line.split(" ", 1) for line in res.stdout.splitlines())
    assert out["records"] == "96"
    jax_pkg = os.path.join(ROOT, "deepfm_tpu") + os.sep
    assert out["source"].startswith(os.path.join(PKG, "native") + os.sep)
    assert out["library"].startswith(os.path.join(PKG, "_build") + os.sep)
    assert jax_pkg not in out["modules"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, name) for line, name in _imported_roots(tree)
           if name in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_tells_the_port_from_the_jax_package():
    """``deepfm_tpu_torch`` starts with ``deepfm_tpu``: the scan must match
    the module name exactly."""
    tree = ast.parse("import deepfm_tpu_torch.ops\n"
                     "from deepfm_tpu_torch import config\n"
                     "from deepfm_tpu.ops import fm\n"
                     "import jax.numpy as jnp\n")
    roots = [name for _, name in _imported_roots(tree)]
    assert [r for r in roots if r in FORBIDDEN] == ["deepfm_tpu", "jax"]


@pytest.mark.parametrize("where", ["alone", "repo"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    """``chip_smoke.py`` exits non-zero and prints no result when no CUDA
    device is visible, and when its directory holds nothing else of the
    repository."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        with open(script, encoding="utf-8") as src, \
                open(tmp_path / "chip_smoke.py", "w", encoding="utf-8") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
