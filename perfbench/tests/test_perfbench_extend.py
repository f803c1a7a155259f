"""A traffic mix, a per-layer metric, a kernel count, a configuration and
a model family are each added as new files plus new BENCHMARK.json
entries, and the harness finds and runs them with no edit to a file
already there."""

import json
import os
import shutil
import subprocess
import sys
import time

from perfbench.core import device_trace, process, registry
from perfbench.tests import tiny


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


#: A second model family, written as a later configuration would write
#: its own: the port's ``--model widedeep`` (DeepFM without the FM term)
#: with Adam, and its plain float32 reference.
WIDEDEEP = '''"""Wide&Deep (``--model widedeep``) with Adam over the Criteo feature
map: logit = b + sum_f W[ids] * vals + tower(flat(V[ids] * vals))."""

import torch
import torch.nn.functional as F

from perfbench.core import compare
from perfbench.gen import traffic as gen
from perfbench.reference import models as ref

TABLES = ("fm_w", "fm_v")


def columns(cell, seed, device):
    t, f = cell["traffic"], cell["config"]["flags"]
    return gen.make_columns(t, vocab=int(f["feature_size"]),
                            fields=int(f["field_size"]),
                            records=int(t["records_per_card"]), seed=seed,
                            device=device)


def weights(cell, shapes, seed, device):
    v = int(cell["config"]["flags"]["feature_size"])
    return gen.make_weights(shapes, seed=seed, device=device,
                            real_rows={k: v for k in TABLES})


def hold(w0, cell, seed):
    return {k: x.cpu() for k, x in w0.items()}


def step_shapes(flags, batch, shapes):
    dims = [int(flags["field_size"]) * int(flags["embedding_size"])]
    dims += [int(x) for x in flags["deep_layers"].split(",")]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:])) + dims[-1]
    return {"batch": batch, "tower": dims, "flops_per_example": 6 * macs}


def first_grad_norms(opt_state):
    return {k: float(torch.linalg.vector_norm(m.double() / (1.0 - 0.9)))
            for k, m in opt_state["mu"].items()}


def _loss(p, batch, l2):
    ids, vals = batch["ids"].long(), batch["vals"]
    xv = p["fm_v"][ids] * vals[..., None]
    z = (p["fm_b"][0] + torch.sum(p["fm_w"][ids] * vals, dim=1)
         + ref.tower(p, xv.reshape(xv.shape[0], -1)))
    reg = 0.5 * (torch.sum(p["fm_w"] ** 2) + torch.sum(p["fm_v"] ** 2))
    return F.binary_cross_entropy_with_logits(z, batch["label"]) + l2 * reg


def reference(cell, held, batches, device, *, quant=False, rows=None):
    if quant:
        raise NotImplementedError("this family has no control")
    flags = cell["config"]["flags"]
    v = int(flags["feature_size"])
    with ref.no_tf32():
        p = {k: (x[:v] if k in TABLES else x).to(device).float()
             .requires_grad_() for k, x in held.items()}
        start = {k: x.detach().clone() for k, x in p.items()}
        opt = ref.Adam(float(flags["learning_rate"]))
        losses, grad1 = [], {}
        for batch in batches:
            if rows is not None:
                batch = {k: x[rows] for k, x in batch.items()}
            value = _loss(p, batch, float(flags["l2_reg"]))
            grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
            losses.append(float(value.detach()))
            grad1 = grad1 or grads
            opt.step(p, grads)
    return {"losses": losses, "grad1": compare.norms(grad1),
            "change": compare.norms({k: p[k].detach() - start[k]
                                     for k in p})}
'''


def _add_widedeep(root):
    """The second family's files and entries, new ones only, in the copy
    at ``root``."""
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (root / "perfbench/families/widedeep.py").write_text(WIDEDEEP)
    config = json.loads((root / "perfbench/configs/deepfm_criteo.json")
                        .read_text())
    config["flags"]["model"] = "widedeep"
    (root / "perfbench/configs/widedeep_criteo.json").write_text(
        json.dumps(config))
    (root / "perfbench/traffic/train.wide.json").write_text(
        (root / "perfbench/traffic/train.uniform.json").read_text())
    (root / "perfbench/limits/widedeep_criteo.train.wide.json").write_text(
        json.dumps({"limits": tiny.LIMITS}))
    (root / "perfbench/metrics/widedeep_mfu_pct.py").write_text(
        'from perfbench.core import registry\n\n'
        'LAYER = "whole step"\nMOVES = "train_examples_per_s"\n\n\n'
        'def read(ctx):\n'
        '    return registry.metric("train_mfu_pct").read(ctx)\n')
    bench["configs"].append({"name": "widedeep_criteo", "source":
                             config["source"], "file":
                             "perfbench/configs/widedeep_criteo.json",
                             "reduced": config["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "widedeep_criteo.train.wide",
                               "config": "widedeep_criteo",
                               "traffic": "train.wide", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "widedeep_mfu_pct", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "train_examples_per_s",
                               "workloads": ["widedeep_criteo.train.wide"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)


def _run_in_subprocess(root, workload, fault):
    code = (
        "import sys, json, time\n"
        f"sys.path.insert(0, {registry.ROOT!r})\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.core import process, registry\n"
        f"tiny.plant({fault!r})\n"
        f"cell = tiny.shrink(registry.Registry({str(root)!r})"
        f".cell({workload!r}))\n"
        "r, lines = process.run_process(cell, seed=5, seconds=0.3, "
        "trace=0, device='cpu', t0=time.time())\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_second_model_family_runs_by_new_files_only(tmp_path):
    """A second family (Wide&Deep) with its configuration, traffic, limits,
    metric and entries, all new, runs through the harness's whole run on
    the CPU at the tiny sizes: correct when sound, not correct with half
    of the batch left out, and no file that was there changed."""
    root = tmp_path
    shutil.copytree(os.path.join(registry.ROOT, "perfbench"),
                    root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    _add_widedeep(root)
    workload = "widedeep_criteo.train.wide"
    reg = registry.Registry(str(root))
    assert reg.family("widedeep").__file__.startswith(str(root))
    for trace in (0, 1):
        cell = tiny.shrink(reg.cell(workload))
        result, lines = process.run_process(
            cell, seed=2**31 + 5, seconds=0.3, trace=trace, device="cpu",
            t0=time.time())
        assert result["correct"], lines
        assert result["attempted"] > 0 and result["failed"] == 0
    # The metric reads the family's operations per example.
    assert result["metrics"]["widedeep_mfu_pct"]["value"] > 0
    assert "train_mfu_pct" not in result["metrics"]
    assert _run_in_subprocess(root, workload, "half_batch")[
        "correct"] is False
    for p, data in before.items():
        assert p.read_bytes() == data, p
