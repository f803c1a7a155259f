"""BENCHMARK.json against the benchmark contract's rules of form, and every
cell resolved to its files by name."""

import json
import os
import re

import pytest

from perfbench.core import registry

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)


def test_command_and_paths(bench):
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    for word in bench["command"][1:]:
        if os.path.sep in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                       c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["reduced"] == c["reduced"]
        assert doc["source"] == c["source"]


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 2 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(bench["per_layer"]) <= 128
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.add(m["layer"])
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def test_check_budget(bench):
    """A full check with 24 cells fits: 2 + 14 x cells runs of
    run_seconds + 60 s, 2 x 90 s a cell to compile, 1200 s spare."""
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_every_cell_resolves_by_name(bench):
    reg = registry.Registry()
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["traffic"]["cards"] == w["chips"]
        assert cell["limits"] and set(cell["limits"]) <= {
            "loss_gap", "grad_gap", "change_gap", "grad_gap_geomean"}
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]


def test_every_metric_file_agrees(bench):
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert callable(mod.read)
    for w in bench["workloads"]:
        for m in bench["per_layer"]:
            for name in m.get("workloads", []):
                assert name in {x["name"] for x in bench["workloads"]}


def test_files_are_named_from_names():
    for dirpath, _, names in os.walk(os.path.join(ROOT, "perfbench")):
        if "__pycache__" in dirpath:
            continue
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), ROOT)
            assert PATH.match(rel), rel
