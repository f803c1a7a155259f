"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

* a configuration: ``perfbench/configs/<config>.json`` (its ``file`` key);
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* a per-layer metric: ``perfbench/metrics/<metric>.py`` (``LAYER``,
  ``MOVES``, ``read(ctx)``);
* a kernel's operations and bytes: ``perfbench/kernels/<kernel>.py``
  (``MATCH``, ``need(shapes)``);
* a model family: ``perfbench/families/<model>.py``, by the
  configuration's ``flags["model"]`` (the functions that
  ``perfbench/families/__init__.py`` names);
* a cell's limits for ``correct``: ``perfbench/limits/<workload>.json``;
* the peaks: ``perfbench/peaks.json``.

Adding any of them is adding a file and, for a cell, a configuration or
a per-layer metric, a ``BENCHMARK.json`` entry; no file here changes.
A cell's files are found under the root of the checkout its registry
reads, which the cell carries as ``root``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _path(kind: str, name: str, root: str) -> str:
    return os.path.join(root, "perfbench", kind, f"{name}.py")


def _module(kind: str, name: str, root: str) -> ModuleType:
    path = _path(kind, name, root)
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, root: str = ROOT, benchmark: Optional[Dict] = None):
        self.root = root
        self.benchmark = (benchmark if benchmark is not None
                          else _json(os.path.join(root, "BENCHMARK.json")))

    def workload(self, name: str) -> Dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> Dict:
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return _json(os.path.join(self.root, self.config_entry(name)["file"]))

    def traffic(self, name: str) -> Dict:
        return _json(os.path.join(self.root, "perfbench", "traffic",
                                  f"{name}.json"))

    def limits(self, workload: str) -> Dict[str, float]:
        """The cell's limits for ``correct``; none for a cell whose limits
        are not set yet (its runs then read ``correct`` false)."""
        path = os.path.join(self.root, "perfbench", "limits",
                            f"{workload}.json")
        return _json(path)["limits"] if os.path.exists(path) else {}

    def peaks(self) -> Dict[str, float]:
        return _json(os.path.join(self.root, "perfbench", "peaks.json"))

    def metric(self, name: str) -> ModuleType:
        return metric(name, self.root)

    def kernel(self, name: str) -> ModuleType:
        return kernel(name, self.root)

    def family(self, name: str) -> ModuleType:
        return family(name, self.root)

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.benchmark["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics a traced run of ``workload`` reports:
        those listing it, and those with no list whose ``moves`` metric the
        cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.benchmark["per_layer"]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def cell(self, workload: str) -> Dict:
        """Everything one run of ``workload`` reads, its files found by
        the names in its entry."""
        w = self.workload(workload)
        return {"root": self.root, "workload": w,
                "config": self.config(w["config"]),
                "traffic": self.traffic(w["traffic"]),
                "limits": self.limits(w["name"]), "peaks": self.peaks(),
                "end_to_end": self.end_to_end(w["name"]),
                "per_layer": self.per_layer(w["name"])}


@functools.lru_cache(maxsize=None)
def metric(name: str, root: str = ROOT) -> ModuleType:
    """The reader of per-layer metric ``name``."""
    return _module("metrics", name, root)


@functools.lru_cache(maxsize=None)
def kernel(name: str, root: str = ROOT) -> ModuleType:
    """The operation and byte count of kernel ``name``."""
    return _module("kernels", name, root)


@functools.lru_cache(maxsize=None)
def family(name: str, root: str = ROOT) -> ModuleType:
    """What the harness needs of model ``name`` (a configuration's
    ``flags["model"]``): its rows, weights, step shapes, first-gradient
    read and plain reference."""
    path = _path("families", name, root)
    if not os.path.isfile(path):
        raise ValueError(f"no reference for model {name!r}: no family file "
                         f"{path}")
    return _module("families", name, root)
