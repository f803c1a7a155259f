"""The port's tasks under data parallelism: ``tasks.run`` train /
eval / infer / export over 2 gloo ranks on the CPU, started by
``deepfm_tpu_torch.fanout`` (its children run ``launch.main(argv,
device="cpu")``), against one process.

The trajectory oracle of a 2-rank train is a single-device ``Trainer``
over the global batches the ranks read: batch t of rank 0's shard
followed by batch t of rank 1's (``tasks.make_pipeline`` with the rank
given). Params within rtol 1e-3 / atol 1e-5 (fm_b rtol 5e-3 / atol 2e-4),
the eval AUC within 5e-3 and loss within 1e-4, ``pred.txt`` in global
record order with probabilities within 1e-5 (its six printed decimals).
Every rank process runs under a hard timeout (the group's own is 60 s).
"""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from deepfm_tpu_torch import fanout
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.parallel import bootstrap
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, F = 3000, 10
FM_B_TOL = dict(rtol=5e-3, atol=2e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
CPU_CHILD = [sys.executable, "-c",
             "import sys; from deepfm_tpu_torch import launch; "
             "sys.exit(launch.main(sys.argv[1:], device='cpu'))"]
# Rank 1 alone pulls the preemption trigger (the env var is read per
# process).
PREEMPT_ONE_RANK_CHILD = [
    sys.executable, "-c",
    "import os, sys; a = sys.argv[1:]; "
    "pid = a[a.index('--process_id') + 1]; "
    "os.environ.update({'DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS': '3'} "
    "if pid == '1' else {}); "
    "from deepfm_tpu_torch import launch; "
    "sys.exit(launch.main(a, device='cpu'))"]
# Rank 1 fails before it ever joins the group.
FAILING_CHILD = [
    sys.executable, "-c",
    "import sys; a = sys.argv[1:]; "
    "pid = a[a.index('--process_id') + 1]; "
    "sys.exit(3) if pid == '1' else None; "
    "from deepfm_tpu_torch import launch; "
    "sys.exit(launch.main(a, device='cpu'))"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dpdata"))
    libsvm.generate_synthetic_ctr(d, num_files=2, examples_per_file=512,
                                  feature_size=V, field_size=F, prefix="tr",
                                  seed=1)
    libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=300,
                                  feature_size=V, field_size=F, prefix="va",
                                  seed=2)
    libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=301,
                                  feature_size=V, field_size=F, prefix="te",
                                  seed=3)
    return d


@pytest.fixture(scope="module", autouse=True)
def _rank_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", ROOT)
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv(bootstrap.TIMEOUT_ENV, "60")
        mp.setenv("DEEPFM_LOG_ALL_RANKS", "1")
        yield


def _kw(data_dir, model_dir, **kw):
    base = dict(data_dir=data_dir, model_dir=model_dir, feature_size=V,
                field_size=F, embedding_size=8, deep_layers="16,8",
                dropout="1,1", batch_size=64, compute_dtype="float32",
                learning_rate=5e-3, steps_per_loop=2, log_steps=4,
                num_epochs=1, seed=7, save_checkpoints_steps=4,
                keep_checkpoint_max=20)
    base.update(kw)
    return base


def _argv(kw):
    out = []
    for k, v in kw.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def _fanout(tmp_path, kw, *, world=2, child=CPU_CHILD, tag="run"):
    """Run ``world`` ranks through ``fanout``: (exit code, the ranks'
    output, each line prefixed ``[worker r]``, fanout's own stderr)."""
    store = tmp_path / f"store-{tag}"
    argv = ["--worker_per_host", str(world), "--coordinator_address",
            f"file://{store}", *_argv(kw)]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fanout.main(argv, child=child)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def trained(data_dir, tmp_path_factory):
    """One 2-rank train task (one epoch, a checkpoint every 2 steps, an
    export): (its flags, its output)."""
    tmp = tmp_path_factory.mktemp("trained")
    kw = _kw(data_dir, str(tmp / "ckpt"), servable_model_dir=str(tmp / "srv"),
             save_checkpoints_steps=2)
    rc, out, _ = _fanout(tmp, {**kw, "task_type": "train"})
    assert rc == 0, out[-4000:]
    return kw, out


def _results(out):
    res = {}
    for m in re.finditer(r"^\[worker (\d+)\] (\{\"task\".*\})$", out,
                         re.MULTILINE):
        res[int(m.group(1))] = json.loads(m.group(2))
    return res


def _single_device_oracle(cfg, files, world=2):
    """The single-device run over the global batches the ``world`` ranks
    of ``cfg`` read in one epoch (rank r's batch t at rows r * B/N), at the
    ranks' learning rate (scaled by ``world`` under ``scale_lr_by_world``,
    the default)."""
    pipes = [tasks.make_pipeline(cfg, files, epochs=1, shuffle=True,
                                 epoch_offset=0, rank=r, world=world)
             for r in range(world)]
    glob = [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
            for bs in zip(*pipes)]
    lr = cfg.learning_rate * (world if cfg.scale_lr_by_world else 1)
    tr = Trainer(cfg.replace(model_dir="", servable_model_dir="",
                             learning_rate=lr), device="cpu")
    state, _ = tr.fit(tr.init_state(), glob)
    return tr, state


def _params(model_dir, cfg):
    tr = Trainer(cfg, device="cpu")
    return ckpt_lib.CheckpointManager(model_dir).restore(tr.init_state())


def _assert_params_close(got, want):
    assert set(got.params) == set(want.params)
    for k in got.params:
        tol = FM_B_TOL if k == "fm_b" else PARAM_TOL
        np.testing.assert_allclose(got.params[k].detach().numpy(),
                                   want.params[k].detach().numpy(),
                                   err_msg=k, **tol)


def test_two_rank_tasks_match_one_process(data_dir, trained, tmp_path):
    """train / eval / infer / export over 2 ranks: the trained params
    against the single-device run over the same global batches; eval and
    ``pred.txt`` against the same tasks in one process on the same
    checkpoint; only rank 0 checkpoints, exports and writes ``pred.txt``
    (every rank logs here)."""
    kw, out = trained
    model_dir = kw["model_dir"]
    res = _results(out)
    assert set(res) == {0, 1}
    assert res[0]["steps"] == res[1]["steps"] == 16
    assert res[0]["collective_applies"] == 16
    assert res[0]["auc"] == res[1]["auc"]
    assert re.search(r"\[worker 0\].*checkpoint saved", out)
    assert not re.search(r"\[worker 1\].*checkpoint saved", out)
    assert re.search(r"\[worker 0\].*exported servable", out)
    assert not re.search(r"\[worker 1\].*exported servable", out)
    assert os.listdir(kw["servable_model_dir"]) == ["16"]
    cfg = Config(**kw)
    files = tasks.resolve_files(data_dir, "tr")
    _, want = _single_device_oracle(cfg, files)
    got = _params(model_dir, cfg)
    assert got.step == want.step == 16
    _assert_params_close(got, want)

    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "eval"}, tag="eval")
    assert rc == 0
    ev2 = _results(out)
    ev1 = tasks.run(cfg.replace(task_type="eval"), device="cpu")
    for r in (0, 1):
        assert abs(ev2[r]["auc"] - ev1["auc"]) <= 5e-3
        assert abs(ev2[r]["loss"] - ev1["loss"]) <= 1e-4

    pred = os.path.join(data_dir, "pred.txt")
    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "infer"},
                         tag="infer")
    assert rc == 0
    assert re.search(r"\[worker 0\].*wrote 301 predictions", out)
    assert not re.search(r"\[worker 1\].*wrote", out)
    with open(pred) as f:
        two = np.array([float(x) for x in f.read().split()])
    assert _results(out)[1]["num_predictions"] == 301
    tasks.run(cfg.replace(task_type="infer"), device="cpu")
    with open(pred) as f:
        one = np.array([float(x) for x in f.read().split()])
    assert len(two) == len(one) == 301
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=0)

    srv2 = str(tmp_path / "srv2")
    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "export",
                                    "servable_model_dir": srv2},
                         tag="export")
    assert rc == 0
    assert os.listdir(srv2) == ["16"]
    assert not re.search(r"\[worker 1\].*exported servable", out)


def test_record_shard_run_matches_single_device(data_dir, tmp_path):
    """One training file for two ranks: each keeps every second record of
    the epoch's order (the record shard), in lockstep."""
    one = tmp_path / "one"
    one.mkdir()
    src = tasks.resolve_files(data_dir, "tr")[0]
    os.symlink(src, one / os.path.basename(src))
    kw = _kw(str(one), str(tmp_path / "ckpt"))
    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "train"})
    assert rc == 0
    res = _results(out)
    assert res[0]["steps"] == 8
    cfg = Config(**kw)
    _, want = _single_device_oracle(cfg, [str(one / os.path.basename(src))])
    _assert_params_close(_params(str(tmp_path / "ckpt"), cfg), want)


def test_resume_position_is_broadcast_after_an_interrupted_run(
        data_dir, trained, tmp_path, monkeypatch):
    """A 2-rank run that crashes after its step-6 checkpoint resumes
    mid-epoch from the chief's broadcast position and ends bit-identical
    to the 2-rank run that was never cut."""
    full, _ = trained
    cut = {**full, "model_dir": str(tmp_path / "cut"),
           "servable_model_dir": ""}
    monkeypatch.setenv(tasks.FAULT_AFTER_ENV, "6")
    assert _fanout(tmp_path, {**cut, "task_type": "train"}, tag="b")[0] != 0
    monkeypatch.delenv(tasks.FAULT_AFTER_ENV)
    rc, out, _ = _fanout(tmp_path, {**cut, "task_type": "train"}, tag="c")
    assert rc == 0
    assert re.search(r"\[worker 0\].*step-accurate resume: epoch 0 \(\+6 "
                     r"batches", out)
    assert _results(out)[1]["steps"] == 16
    cfg = Config(**full)
    a = _params(full["model_dir"], cfg)
    b = _params(str(tmp_path / "cut"), cfg)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_preemption_flag_is_ored_across_ranks(data_dir, tmp_path):
    """Only rank 1 is preempted; at the next agreed dispatch both ranks
    save at the same step and exit 42."""
    kw = _kw(data_dir, str(tmp_path / "ckpt"))
    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "train"},
                         child=PREEMPT_ONE_RANK_CHILD)
    assert rc == 42
    res = _results(out)
    assert res[0]["preempted"] and res[1]["preempted"]
    assert res[0]["step"] == res[1]["step"] == 4
    assert ckpt_lib.CheckpointManager(kw["model_dir"]).latest_step() == 4


def test_multi_path_channels(data_dir, tmp_path):
    """``--enable_data_multi_path``: local worker r trains its own channel
    (``<data_dir>/c<r>``), the eval channel first in the list."""
    root = tmp_path / "chan"
    for name, seed in (("c0", 11), ("c1", 12)):
        libsvm.generate_synthetic_ctr(str(root / name), num_files=1,
                                      examples_per_file=256, feature_size=V,
                                      field_size=F, prefix="tr", seed=seed)
    libsvm.generate_synthetic_ctr(str(root / "va"), num_files=1,
                                  examples_per_file=128, feature_size=V,
                                  field_size=F, prefix="va", seed=13)
    kw = _kw(str(root), str(tmp_path / "ckpt"),
             channels='["va","c0","c1"]', enable_data_multi_path=True)
    rc, out, _ = _fanout(tmp_path, {**kw, "task_type": "train"})
    assert rc == 0
    res = _results(out)
    assert res[0]["steps"] == 8
    cfg = Config(**kw, worker_per_host=2)
    pipes = [tasks.make_pipeline(
        cfg, tasks.resolve_files(str(root / f"c{r}"), "tr"), rank=r,
        world=2) for r in range(2)]
    glob = [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
            for bs in zip(*pipes)]
    tr = Trainer(cfg.replace(model_dir="", learning_rate=2 * cfg.learning_rate),
                 device="cpu")
    want, _ = tr.fit(tr.init_state(), glob)
    _assert_params_close(_params(str(tmp_path / "ckpt"), cfg), want)


def test_a_failing_child_takes_its_sibling_down(data_dir, tmp_path):
    """fanout: rank 1 exits 3 before joining the group; rank 0, waiting in
    the rendezvous, is terminated and fanout returns 3 (not a hang)."""
    import time  # noqa: PLC0415
    kw = _kw(data_dir, str(tmp_path / "ckpt"), task_type="train")
    t0 = time.time()
    rc, _, err = _fanout(tmp_path, kw, child=FAILING_CHILD)
    assert rc == 3
    assert time.time() - t0 < 45
    assert "terminating 1 remaining worker" in err


def test_online_mode_with_two_processes_raises_as_jax(data_dir, monkeypatch):
    import jax  # noqa: PLC0415
    from deepfm_tpu.config import Config as JaxConfig  # noqa: PLC0415
    from deepfm_tpu.train import tasks as jax_tasks  # noqa: PLC0415
    kw = dict(online_mode=True, pipe_mode=1, feature_size=V, field_size=F,
              batch_size=64)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(bootstrap, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError) as want:
        jax_tasks.make_online_pipeline(JaxConfig(**kw), data_dir)
    with pytest.raises(NotImplementedError) as got:
        tasks.make_online_pipeline(Config(**kw), data_dir)
    assert str(got.value) == str(want.value)


def test_mesh_model_still_raises_naming_item_4(data_dir, tmp_path):
    """The model axis and ``--embedding_shard rows`` under a mesh are
    ported: the tasks' up-front check passes them when the mesh
    covers ``--num_processes``, and raises ``ValueError`` naming
    ``--mesh_data`` / ``--mesh_model`` (never a queue item) when it does
    not."""
    ok = dict(mesh_model=2, dist_mode=1, num_processes=2)
    tasks.check_task_ported(Config(**_kw(data_dir, str(tmp_path), **ok)))
    tasks.check_task_ported(Config(**_kw(
        data_dir, str(tmp_path), embedding_update="sparse",
        embedding_shard="rows", mesh_data=2, dist_mode=1,
        num_processes=2)))
    for bad, flag in ((dict(ok, num_processes=3), "--mesh_model 2"),
                      (dict(ok, mesh_data=2), "--mesh_data 2")):
        with pytest.raises(ValueError, match=flag) as e:
            tasks.check_task_ported(Config(**_kw(data_dir, str(tmp_path),
                                                 **bad)))
        assert "queue 1" not in str(e.value)


@pytest.mark.parametrize("world,counts", [(2, [3, 2]), (3, [4, 4, 3]),
                                          (4, [1, 0, 0, 0]), (1, [5])])
def test_interleave_rank_shards_matches_jax(world, counts):
    from deepfm_tpu.train import tasks as jax_tasks  # noqa: PLC0415
    rng = np.random.default_rng(world)
    gathered = rng.random((world, max(counts), 2)).astype(np.float32)
    counts = np.asarray(counts)
    np.testing.assert_array_equal(
        tasks._interleave_rank_shards(gathered, counts),
        jax_tasks._interleave_rank_shards(gathered, counts))
