"""The port's preemption runtime (``deepfm_tpu_torch.utils.preempt``), its
train task's preemption, fault-injection and rollback paths, and the
launcher's exit codes, on the CPU, mirroring ``tests/test_preempt.py``.

A preempted run force-saves a checkpoint and the resume sidecar, then
raises ``Preempted`` (the launcher exits 42); resumed, it ends
bit-identical to an uninterrupted run. Under ``on_nonfinite=rollback`` a
poisoned batch (``utils.faults.set_nan_plan``) restores the latest
checkpoint and replays to the same final state. Dropout is on: the
dropout generator's state rides in every checkpoint.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deepfm_tpu.utils import preempt as jax_preempt
from deepfm_tpu_torch import launch
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.train import guard as guard_lib
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import faults
from deepfm_tpu_torch.utils import preempt as preempt_lib

torch.set_num_threads(1)

FEATURE_SIZE = 64
FIELD_SIZE = 5
BATCHES_PER_EPOCH = 6  # 2 files x 48 records / batch_size 16


@pytest.fixture(autouse=True)
def _clean_listener():
    """The process-wide flag and NaN plan never leak between tests."""
    yield
    preempt_lib.get_listener().clear()
    faults.take_nan_plan()


# ---------------------------------------------------------------------------
# Listener and exit codes
# ---------------------------------------------------------------------------

def test_listener_trigger_and_clear():
    lst = preempt_lib.PreemptionListener()
    assert not lst.triggered()
    lst.trigger("spot notice")
    assert lst.triggered() and lst.reason == "spot notice"
    lst.clear()
    assert not lst.triggered() and lst.reason == ""


def test_real_signal_sets_flag():
    lst = preempt_lib.PreemptionListener(signals=(signal.SIGTERM,))
    with lst:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5.0
        while not lst.triggered() and time.time() < deadline:
            time.sleep(0.01)
        assert lst.triggered()
        assert lst.reason == f"signal {int(signal.SIGTERM)}"


def test_uninstall_restores_prior_handler():
    prior = signal.getsignal(signal.SIGTERM)
    lst = preempt_lib.PreemptionListener(signals=(signal.SIGTERM,))
    lst.install()
    assert signal.getsignal(signal.SIGTERM) != prior
    lst.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prior


def test_exit_code_contract_matches_jax():
    assert preempt_lib.EXIT_PREEMPTED == jax_preempt.EXIT_PREEMPTED == 42
    assert preempt_lib.EXIT_WATCHDOG == jax_preempt.EXIT_WATCHDOG == 43
    assert (preempt_lib.RESTARTABLE_EXIT_CODES
            == jax_preempt.RESTARTABLE_EXIT_CODES == {42, 43})
    assert 0 not in preempt_lib.RESTARTABLE_EXIT_CODES
    assert 1 not in preempt_lib.RESTARTABLE_EXIT_CODES
    p = preempt_lib.Preempted(7, "test")
    assert p.step == 7 and "preempted at step 7 (test)" in str(p)


def test_get_listener_is_process_wide():
    assert preempt_lib.get_listener() is preempt_lib.get_listener()


# ---------------------------------------------------------------------------
# Task level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("preempt")
    libsvm.generate_synthetic_ctr(
        str(d / "data"), num_files=2, examples_per_file=48,
        feature_size=FEATURE_SIZE, field_size=FIELD_SIZE, prefix="tr",
        seed=5)
    return d


def _cfg(workdir, model_dir, **kw):
    base = dict(
        task_type="train", data_dir=str(workdir / "data"),
        model_dir=model_dir, feature_size=FEATURE_SIZE,
        field_size=FIELD_SIZE, embedding_size=4, deep_layers="8",
        dropout="0.5", batch_size=16, num_epochs=2,
        compute_dtype="float32", log_steps=0, learning_rate=0.01,
        scale_lr_by_world=False, seed=17, steps_per_loop=1,
        shuffle_buffer=64)
    base.update(kw)
    return Config(**base)


def _final(cfg):
    trainer = Trainer(cfg, device="cpu")
    mgr = ckpt_lib.CheckpointManager(cfg.model_dir)
    state = mgr.restore(trainer.init_state())
    params = {k: v.detach().clone() for k, v in state.params.items()}
    return params, int(state.step), state.rng.get_state()


def _assert_equal(a, b, what):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


BASELINES = {
    "single": {},
    "accum": {"steps_per_loop": 2, "grad_accum_steps": 2},
}


@pytest.fixture(scope="module")
def baselines(workdir):
    """Uninterrupted 2-epoch runs: the oracles of preempt-resume and
    rollback-replay (the checkpoint cadence never changes the
    trajectory)."""
    out = {}
    for name, kw in BASELINES.items():
        cfg = _cfg(workdir, str(workdir / f"ckpt_base_{name}"), **kw)
        res = tasks.run(cfg, device="cpu")
        params, step, rng = _final(cfg)
        assert step == res["steps"] == 2 * BATCHES_PER_EPOCH
        out[name] = params, step, rng
    return out


@pytest.mark.parametrize("name,after", [("single", 3), ("accum", 4)])
def test_injected_preemption_then_resume_is_bit_identical(
        workdir, baselines, monkeypatch, name, after):
    """The env trigger fires mid-epoch: the task force-saves at the
    dispatch's step and raises Preempted; a restart resumes from the
    sidecar to the uninterrupted run's final state, bit for bit."""
    params_base, step_base, rng_base = baselines[name]
    ckpt = str(workdir / f"ckpt_preempted_{name}")
    cfg = _cfg(workdir, ckpt, **BASELINES[name])
    monkeypatch.setenv(tasks.PREEMPT_AFTER_ENV, str(after))
    with pytest.raises(preempt_lib.Preempted) as ei:
        tasks.run(cfg, device="cpu")
    assert ei.value.step == after
    assert _final(cfg)[1] == after
    meta = tasks._read_resume_meta(ckpt, guard_lib.TrainHealth())
    assert meta["step"] == after and not meta["completed"]

    monkeypatch.delenv(tasks.PREEMPT_AFTER_ENV)
    preempt_lib.get_listener().clear()
    res = tasks.run(cfg, device="cpu")
    assert res["preemptions"] == 0.0
    params, step, rng = _final(cfg)
    assert step == step_base and torch.equal(rng, rng_base)
    _assert_equal(params_base, params, "preempt-resume vs uninterrupted")


def test_flag_set_before_training_preempts_at_first_dispatch(workdir):
    listener = preempt_lib.get_listener()
    listener.trigger("notice during startup")
    cfg = _cfg(workdir, str(workdir / "ckpt_early"))
    with pytest.raises(preempt_lib.Preempted) as ei:
        tasks.run(cfg, device="cpu")
    assert ei.value.step == 1
    assert _final(cfg)[1] == 1


def test_preempt_hold_waits_for_a_signal_then_preempts(workdir,
                                                       monkeypatch):
    """The hold hook writes its sentinel after 2 steps and blocks until the
    listener fires (a real signal in a drill; the injectable trigger
    here), then the task force-saves and raises Preempted there."""
    ckpt = str(workdir / "ckpt_hold")
    cfg = _cfg(workdir, ckpt)
    monkeypatch.setenv(tasks.PREEMPT_HOLD_ENV, "2")
    out = {}

    def run():
        try:
            tasks.run(cfg, device="cpu")
        except preempt_lib.Preempted as e:
            out["step"] = e.step

    t = threading.Thread(target=run)
    t.start()
    sentinel = os.path.join(ckpt, ".preempt_hold")
    deadline = time.time() + 60
    while not os.path.exists(sentinel) and time.time() < deadline:
        time.sleep(0.01)
    with open(sentinel, encoding="utf-8") as f:
        assert f.read() == "2"
    assert t.is_alive()  # held, waiting for the signal
    preempt_lib.get_listener().trigger("drill signal")
    t.join(60)
    assert out == {"step": 2} and _final(cfg)[1] == 2


def test_fault_injection_crash_then_resume_is_bit_identical(
        workdir, baselines, monkeypatch):
    """The fault hook raises after 5 steps, after the step-4 checkpoint;
    the restart replays from it to the uninterrupted run's state."""
    params_base, step_base, _ = baselines["single"]
    cfg = _cfg(workdir, str(workdir / "ckpt_fault"),
               save_checkpoints_steps=4)
    monkeypatch.setenv(tasks.FAULT_AFTER_ENV, "5")
    with pytest.raises(RuntimeError, match="fault injection"):
        tasks.run(cfg, device="cpu")
    assert _final(cfg)[1] == 4
    monkeypatch.delenv(tasks.FAULT_AFTER_ENV)
    tasks.run(cfg, device="cpu")
    params, step, _ = _final(cfg)
    assert step == step_base
    _assert_equal(params_base, params, "crash-resume vs uninterrupted")


def test_skip_counts_in_result(workdir):
    faults.set_nan_plan([2])
    cfg = _cfg(workdir, str(workdir / "ckpt_skip"), on_nonfinite="skip")
    res = tasks.run(cfg, device="cpu")
    assert res["nonfinite_skips"] == 1.0 and res["rollbacks"] == 0.0
    # The poisoned dispatch was consumed but not trained.
    assert res["steps"] == 2 * BATCHES_PER_EPOCH - 1
    assert res["staging_overlap_fraction"] >= 0.0


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_rollback_replays_from_checkpoint_bit_identically(
        workdir, baselines, name):
    """Checkpoints every 2 steps; batch index 4 poisons. The rollback
    restores step 4 and replays from the recorded offset; the plan was
    consumed, so the replayed batch is clean and the final state equals
    the uninterrupted run's."""
    params_base, step_base, rng_base = baselines[name]
    faults.set_nan_plan([4])
    cfg = _cfg(workdir, str(workdir / f"ckpt_rollback_{name}"),
               on_nonfinite="rollback", save_checkpoints_steps=2,
               **BASELINES[name])
    res = tasks.run(cfg, device="cpu")
    assert res["rollbacks"] == 1.0 and res["steps"] == step_base
    params, step, rng = _final(cfg)
    assert step == step_base and torch.equal(rng, rng_base)
    _assert_equal(params_base, params, "rollback-replay vs uninterrupted")


def test_rollback_without_checkpoint_aborts(workdir):
    faults.set_nan_plan([1])
    cfg = _cfg(workdir, "", on_nonfinite="rollback")
    with pytest.raises(guard_lib.NonFiniteError,
                       match="no checkpoint exists"):
        tasks.run(cfg, device="cpu")


def test_abort_raises_with_step_number(workdir):
    faults.set_nan_plan([1])
    cfg = _cfg(workdir, str(workdir / "ckpt_abort"), on_nonfinite="abort",
               log_steps=1)
    with pytest.raises(guard_lib.NonFiniteError, match="at step 2"):
        tasks.run(cfg, device="cpu")


def test_corrupt_sidecar_degrades_to_checkpoint_step_resume(workdir):
    ckpt = str(workdir / "ckpt_torn")
    cfg = _cfg(workdir, ckpt, num_epochs=1)
    tasks.run(cfg, device="cpu")
    with open(os.path.join(ckpt, tasks._RESUME_META), "w") as f:
        f.write('{"step": 6, "ep')  # torn write mid-preemption
    res = tasks.run(cfg, device="cpu")  # must not raise
    assert res["resume_meta_corrupt"] >= 1.0
    assert res["steps"] == 2 * BATCHES_PER_EPOCH


def test_poisoner_poisons_planned_batches_once():
    faults.set_nan_plan([1, 3])
    plan = faults.take_nan_plan()
    assert faults.take_nan_plan() is None
    src = [{"feat_vals": np.ones((2, 3), np.float32)} for _ in range(5)]
    p = faults.BatchPoisoner(src, **plan)
    out = list(p)
    assert p.poisoned == 2 and p.health is None
    assert [bool(np.isnan(b["feat_vals"]).all()) for b in out] == [
        False, True, False, True, False]
    assert not np.isnan(src[1]["feat_vals"]).any()  # source left alone


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def test_preempted_maps_to_exit_42(workdir, monkeypatch, capsys):
    def fake_run(cfg, device="cuda"):
        raise preempt_lib.Preempted(7, "test")

    monkeypatch.setattr(tasks, "run", fake_run)
    rc = launch.main(["--task_type", "train",
                      "--data_dir", str(workdir / "data")], device="cpu")
    assert rc == preempt_lib.EXIT_PREEMPTED
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"task": "train", "preempted": True, "step": 7}


def test_cli_preempt_after_exits_42_and_resumes(workdir, baselines,
                                                monkeypatch, capsys):
    """The launcher with the preempt-after hook: exit 42 and the preempted
    line; run again without it, the final checkpoint equals the
    uninterrupted run's."""
    params_base, step_base, _ = baselines["single"]
    ckpt = str(workdir / "ckpt_cli")
    argv = ["--task_type", "train", "--data_dir", str(workdir / "data"),
            "--model_dir", ckpt]
    cfg = _cfg(workdir, ckpt)
    default = Config().to_dict()
    for k, v in cfg.to_dict().items():
        if k not in ("task_type", "data_dir", "model_dir") and \
                v != default[k]:
            argv += [f"--{k}", str(v)]
    monkeypatch.setenv(tasks.PREEMPT_AFTER_ENV, "2")
    assert launch.main(argv, device="cpu") == 42
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"task": "train", "preempted": True, "step": 2}
    monkeypatch.delenv(tasks.PREEMPT_AFTER_ENV)
    preempt_lib.get_listener().clear()
    assert launch.main(argv, device="cpu") == 0
    params, step, _ = _final(cfg)
    assert step == step_base
    _assert_equal(params_base, params, "CLI preempt-resume")
