"""The tasks on a model axis: ``python -m deepfm_tpu_torch.fanout
--worker_per_host 2 --mesh_model 2`` (or ``--mesh_data 2 --mesh_model 1``
for the data-only row plane) trains, evaluates, infers and exports over 2
gloo ranks on the CPU, against the same tasks in one process.

Each leg is one fanout whose two children (``launch.main(argv,
device="cpu")``) run the four tasks in turn, each on a ``file://`` store
of its own; the five legs' fanouts run side by side under one deadline.
The legs: the dense update over ``masked_psum`` and ``allgather_table``,
the row plane monolithic and hashed (1x2), and the row plane on the data
axis (2x1). Held: a 1x2 run's checkpoint (the full, gathered tables), its
eval result, its ``pred.txt`` and its artifact's answers bit-equal to the
one-process run's; the 2x1 run against the single-device run over the
same global batches (params rtol 1e-3 / atol 1e-5, fm_b rtol 5e-3 / atol
2e-4; eval AUC 5e-3, loss 1e-4; ``pred.txt`` 1e-5, its six decimals).
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepfm_tpu_torch import fanout
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.parallel import bootstrap
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, F = 3000, 10
FM_B_TOL = dict(rtol=5e-3, atol=2e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
TIMEOUT_S = 240
TASKS = ("train", "eval", "infer", "export")
# The child: the four tasks in turn, each on a store of its own.
CHILD = [sys.executable, "-c", "\n".join([
    "import sys",
    "from deepfm_tpu_torch import launch",
    "a = sys.argv[1:]",
    "i = a.index('--coordinator_address') + 1",
    "store = a[i]",
    "for t in ('train', 'eval', 'infer', 'export'):",
    "    a[i] = store + '.' + t",
    "    rc = launch.main(a + ['--task_type', t], device='cpu')",
    "    if rc:",
    "        sys.exit(rc)"])]
ROWS = dict(embedding_update="sparse", embedding_shard="rows")
LEGS = {
    "dense": dict(mesh_model=2),
    "allgather": dict(mesh_model=2, embedding_lookup="allgather_table"),
    "rows": dict(ROWS, mesh_model=2),
    "rows_hashed": dict(ROWS, mesh_model=2, embedding_buckets="2048,1024"),
    "rows_dp": dict(ROWS, mesh_data=2, mesh_model=1),
}


def _kw(data_dir, run, **kw):
    base = dict(data_dir=data_dir, model_dir=os.path.join(run, "ckpt"),
                servable_model_dir=os.path.join(run, "srv"),
                feature_size=V, field_size=F, embedding_size=8,
                deep_layers="16,8", dropout="1,1", batch_size=64,
                compute_dtype="float32", learning_rate=5e-3,
                steps_per_loop=2, log_steps=4, num_epochs=1, seed=7,
                save_checkpoints_steps=4, keep_checkpoint_max=20)
    base.update(kw)
    return base


def _argv(kw):
    out = []
    for k, v in kw.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def _results(out):
    """{task: {rank: result line}} of the children's output."""
    res = {}
    for m in re.finditer(r"^\[worker (\d+)\] (\{\"task\".*\})$", out,
                         re.MULTILINE):
        line = json.loads(m.group(2))
        res.setdefault(line["task"], {})[int(m.group(1))] = line
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every leg's data directory (the shared records, its own
    ``pred.txt``), flags and fanout output, the fanouts side by side."""
    src = str(tmp_path_factory.mktemp("mpdata"))
    libsvm.generate_synthetic_ctr(src, num_files=2, examples_per_file=512,
                                  feature_size=V, field_size=F, prefix="tr",
                                  seed=1)
    libsvm.generate_synthetic_ctr(src, num_files=1, examples_per_file=300,
                                  feature_size=V, field_size=F, prefix="va",
                                  seed=2)
    libsvm.generate_synthetic_ctr(src, num_files=1, examples_per_file=301,
                                  feature_size=V, field_size=F, prefix="te",
                                  seed=3)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           bootstrap.TIMEOUT_ENV: "60", "DEEPFM_LOG_ALL_RANKS": "1"}
    procs, legs = {}, {}
    for leg, over in LEGS.items():
        tmp = tmp_path_factory.mktemp(f"mptask_{leg}")
        data = tmp / "data"
        data.mkdir()
        for name in os.listdir(src):
            os.symlink(os.path.join(src, name), data / name)
        kw = _kw(str(data), str(tmp), **over)
        argv = ["--worker_per_host", "2", "--coordinator_address",
                f"file://{tmp / 'store'}", *_argv(kw)]
        code = ("import sys, json; from deepfm_tpu_torch import fanout; "
                f"sys.exit(fanout.main(json.loads(sys.argv[1]), "
                f"child=json.loads(sys.argv[2])))")
        procs[leg] = subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(argv),
             json.dumps(CHILD)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        legs[leg] = {"kw": kw, "tmp": tmp}
    deadline = time.time() + TIMEOUT_S
    for leg, p in procs.items():
        try:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        legs[leg].update(rc=p.returncode, out=out)
    return legs


def _one_process(run, leg, task):
    """``tasks.run`` of ``task`` in one process on the leg's model_dir and
    data (the mesh flags dropped)."""
    kw = {k: v for k, v in run["kw"].items()
          if k not in ("mesh_data", "mesh_model")}
    return Config(**kw).replace(task_type=task)


def _ckpt(model_dir, cfg):
    tr = Trainer(cfg.replace(mesh_data=0, mesh_model=1), device="cpu")
    return ckpt_lib.CheckpointManager(model_dir).restore(tr.init_state())


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_fanout_runs_the_four_tasks_on_the_mesh(runs, leg):
    """Both ranks run train, eval, infer and export; only rank 0 writes
    checkpoints, the artifact and ``pred.txt``; a rows leg reports its
    exchange (model axis) or its gradient all_reduce (data axis), and the
    sparse update under the data-only mesh no longer trains dense."""
    run = runs[leg]
    assert run["rc"] == 0, run["out"][-6000:]
    res = _results(run["out"])
    assert set(res) == set(TASKS)
    for t in TASKS:
        assert set(res[t]) == {0, 1}, t
    train = res["train"]
    assert train[0]["steps"] == train[1]["steps"] == 16
    assert np.isfinite(train[0]["loss"])
    out = run["out"]
    for what in ("checkpoint saved", "exported servable", "wrote 301"):
        assert re.search(rf"\[worker 0\].*{what}", out), what
        assert not re.search(rf"\[worker 1\].*{what}", out), what
    assert "falling back to dense" not in out
    assert os.listdir(run["kw"]["servable_model_dir"]) == ["16"]
    if LEGS[leg].get("mesh_model", 1) > 1 and "embedding_shard" in LEGS[leg]:
        assert train[0]["exchange_bytes"] > 0
    if LEGS[leg].get("mesh_data", 0) == 2:
        assert train[0]["collective_applies"] == 16


@pytest.mark.parametrize("leg", ["dense", "allgather", "rows",
                                 "rows_hashed"])
def test_model_axis_tasks_bit_equal_one_process(runs, leg, tmp_path):
    """A 1x2 run reads the batches one process reads: its checkpoint (the
    gathered full state), its eval result, its ``pred.txt`` and its
    artifact's answers equal the one-process tasks' bit for bit."""
    run = runs[leg]
    assert run["rc"] == 0, run["out"][-6000:]
    res = _results(run["out"])
    one_dir = str(tmp_path / "one")
    cfg = _one_process(run, leg, "train").replace(
        model_dir=os.path.join(one_dir, "ckpt"),
        servable_model_dir=os.path.join(one_dir, "srv"))
    tasks.run(cfg, device="cpu")
    a = _ckpt(run["kw"]["model_dir"], cfg)
    b = _ckpt(cfg.model_dir, cfg)
    assert a.step == b.step == 16
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k]), k
    ev = tasks.run(cfg.replace(task_type="eval"), device="cpu")
    for r in (0, 1):
        for key in ("auc", "loss", "examples"):
            assert res["eval"][r][key] == ev[key], key
    pred = os.path.join(run["kw"]["data_dir"], "pred.txt")
    with open(pred) as f:
        two = f.read()
    tasks.run(cfg.replace(task_type="infer"), device="cpu")
    with open(pred) as f:
        assert f.read() == two
    ids = np.random.default_rng(0).integers(0, V, (37, F)).astype(np.int32)
    vals = np.random.default_rng(1).random((37, F)).astype(np.float32)
    got = export_lib.load_serving(os.path.join(
        run["kw"]["servable_model_dir"], "16"), device="cpu")(ids, vals)
    want = export_lib.load_serving(os.path.join(
        cfg.servable_model_dir, "16"), device="cpu")(ids, vals)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_data_axis_row_plane_matches_single_device(runs):
    """The row plane on the data axis (2x1, JAX's sharded sparse step with
    one shard) against the single-device sparse run over the ranks' global
    batches at the ranks' learning rate; its eval and ``pred.txt`` against
    the one-process tasks on the same checkpoint."""
    run = runs["rows_dp"]
    assert run["rc"] == 0, run["out"][-6000:]
    res = _results(run["out"])
    cfg = _one_process(run, "rows_dp", "train")
    files = tasks.resolve_files(run["kw"]["data_dir"], "tr")
    pipes = [tasks.make_pipeline(cfg, files, epochs=1, rank=r, world=2)
             for r in range(2)]
    glob = [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
            for bs in zip(*pipes)]
    tr = Trainer(cfg.replace(model_dir="", servable_model_dir="",
                             learning_rate=2 * cfg.learning_rate),
                 device="cpu")
    want, _ = tr.fit(tr.init_state(), glob)
    got = _ckpt(run["kw"]["model_dir"], cfg)
    assert got.step == want.step == 16
    for k in want.params:
        tol = FM_B_TOL if k == "fm_b" else PARAM_TOL
        np.testing.assert_allclose(got.params[k].detach().numpy(),
                                   want.params[k].detach().numpy(),
                                   err_msg=k, **tol)
    ev = tasks.run(cfg.replace(task_type="eval"), device="cpu")
    for r in (0, 1):
        assert abs(res["eval"][r]["auc"] - ev["auc"]) <= 5e-3
        assert abs(res["eval"][r]["loss"] - ev["loss"]) <= 1e-4
    pred = os.path.join(run["kw"]["data_dir"], "pred.txt")
    with open(pred) as f:
        two = np.array([float(x) for x in f.read().split()])
    tasks.run(cfg.replace(task_type="infer"), device="cpu")
    with open(pred) as f:
        one = np.array([float(x) for x in f.read().split()])
    assert len(two) == len(one) == 301
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flags,match", [
    (["--mesh_model", "3"], "--mesh_model 3 does not divide"),
    (["--mesh_data", "2", "--mesh_model", "2"], "--mesh_data 2 x "
                                                "--mesh_model 2")])
def test_fanout_checks_the_mesh_before_any_child(flags, match, tmp_path):
    """``fanout`` refuses a mesh that does not cover its processes with a
    ``ValueError`` naming the flags, before it starts a child."""
    marker = tmp_path / "started"
    child = [sys.executable, "-c",
             f"open({str(marker)!r}, 'w').close()"]
    with pytest.raises(ValueError, match=match):
        fanout.main(["--worker_per_host", "2", *flags], child=child)
    assert not marker.exists()
