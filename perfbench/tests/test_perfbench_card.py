"""On the card: one short run of each declared cell through the command,
its last line the contract's object. Skips on a host without a card."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.core import registry


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    bench = registry.Registry().benchmark
    for w in bench["workloads"]:
        if torch.cuda.device_count() < w["chips"]:
            continue
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", w["name"],
             "--seed", "2147483011", "--seconds", "2", "--trace",
             str(trace)], capture_output=True, text=True, timeout=900,
            cwd=registry.ROOT, check=True)
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(last)
        assert last["device"]["count"] == w["chips"]
        assert os.path.exists(os.path.join(registry.ROOT, "BENCHMARK.json"))
