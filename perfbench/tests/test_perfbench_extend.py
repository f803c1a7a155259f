"""A traffic mix, a per-layer metric, a kernel count and a configuration
are each added as new files plus new BENCHMARK.json entries, and the
harness's loading finds them with no edit to a file already there."""

import json
import os
import shutil

from perfbench.core import device_trace, registry


def test_new_files_and_entries_load(tmp_path):
    root = tmp_path
    shutil.copytree(os.path.join(registry.ROOT, "perfbench"),
                    root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "perfbench").rglob("*") if x.is_file())}
    # New files only.
    with open(root / "perfbench/traffic/train.dummy.json", "w") as f:
        json.dump({"cards": 1, "batch_per_card": 8,
                   "records_per_card": 64, "integer_fields": 2,
                   "steps_per_loop": 2, "steps_per_call": 4,
                   "epoch_orders": 1, "trace_steps": 2,
                   "checked_steps": 3}, f)
    with open(root / "perfbench/configs/dummy_model.json", "w") as f:
        json.dump({"source": "https://example.org/dummy", "reduced": [],
                   "flags": {"model": "deepfm"}}, f)
    with open(root / "perfbench/limits/dummy_model.train.dummy.json",
              "w") as f:
        json.dump({"limits": {"loss_gap": 1.0}}, f)
    (root / "perfbench/metrics/dummy_count.py").write_text(
        'LAYER = "dummy layer"\nMOVES = "train_examples_per_s"\n\n\n'
        "def read(ctx):\n    return float(len(ctx.kernels(('dummy',))))\n")
    (root / "perfbench/kernels/dummy_kernel.py").write_text(
        'MATCH = ("dummy",)\n\n\ndef need(s):\n'
        '    return [(0, 4 * s["batch"], "f32_flops_per_s")]\n')
    # New entries only.
    bench["configs"].append({"name": "dummy_model", "source":
                             "https://example.org/dummy", "file":
                             "perfbench/configs/dummy_model.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_model.train.dummy",
                               "config": "dummy_model",
                               "traffic": "train.dummy", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_count", "unit": "launches",
                               "better": "lower", "source": "device_trace",
                               "layer": "dummy layer",
                               "moves": "train_examples_per_s",
                               "workloads": ["dummy_model.train.dummy"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    reg = registry.Registry(str(root))
    cell = reg.cell("dummy_model.train.dummy")
    assert cell["traffic"]["batch_per_card"] == 8
    assert cell["config"]["flags"]["model"] == "deepfm"
    assert cell["limits"] == {"loss_gap": 1.0}
    assert "dummy_count" in {m["name"] for m in cell["per_layer"]}
    assert "dummy_count" not in {
        m["name"] for m in reg.cell("deepfm_criteo.train.uniform")["per_layer"]}
    metric = reg.metric("dummy_count")
    ctx = device_trace.Context(
        ops=[device_trace.DeviceOp("dummy_k", "kernel", 0, 10)], spans=[],
        t0=0, t1=100, steps=1, examples_per_s=1.0, cards=1,
        shapes={"batch": 8}, peaks=reg.peaks(),
        kernel=lambda n: registry.kernel(n, str(root)))
    assert metric.read(ctx) == 1.0
    assert ctx.least_seconds("dummy_kernel") > 0
    # No file that was there changed.
    for p, data in before.items():
        assert open(p, "rb").read() == data
