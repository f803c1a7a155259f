"""The harness's run with the program's timed path broken underneath (the
card's look skipped): ``correct`` comes out false for each fault a
training cell can have."""

import json
import subprocess
import sys
import time

import pytest

from perfbench.core import registry

CELLS = ["deepfm_criteo.train.uniform"]
ROOT = registry.ROOT


def _in_subprocess(workload, fault):
    """One run in a fresh process (a planted fault patches the program)."""
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.core import process, registry\n"
        f"tiny.plant({fault!r})\n"
        f"cell = tiny.shrink(registry.Registry().cell({workload!r}))\n"
        "r, lines = process.run_process(cell, seed=5, seconds=0.3, "
        "trace=0, device='cpu', t0=time.time())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_is_not_correct(workload, fault):
    result = _in_subprocess(workload, fault)
    assert result["correct"] is False


def test_unchanged_state_reads_one():
    """A state left unchanged reads 1 on the change number."""
    from perfbench.core import compare
    ref = {"losses": [0.7, 0.69, 0.68], "grad1": {"a": 1.0, "b": 2.0},
           "change": {"a": 0.1, "b": 0.3}}
    prog = dict(ref, change={"a": 0.0, "b": 0.0})
    assert compare.gaps(prog, ref)["change_gap"] == 1.0
