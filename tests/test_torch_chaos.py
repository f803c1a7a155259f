"""The port's chaos schedule (``ChaosEvent``/``ChaosSchedule`` and
``install_env_faults`` of ``deepfm_tpu_torch.utils.faults``) and its
supervisor (``deepfm_tpu_torch.drills.supervise``) against the JAX
package's.

The repair: the port's ``install_env_faults`` used to read only
``DEEPFM_TPU_READ_FAULT_EVERY``, so a port trainer launched under
``DEEPFM_TPU_CHAOS_SCHEDULE`` got no faults at all. Under a schedule
holding a ``read_faults`` event it now arms a ``FlakyFS`` as the JAX one
does, and the armed injector fails the port's reads. Schedules are
seed-pure: the same ``generate`` call gives the same ``to_json()`` string
and ``fingerprint()`` in both packages (tolerance: none).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from deepfm_tpu.data import fileio as jax_fileio
from deepfm_tpu.utils import faults as jax_faults
from deepfm_tpu_torch.data import fileio
from deepfm_tpu_torch.drills import supervise
from deepfm_tpu_torch.utils import faults

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "scripts"))
import supervise as jax_supervise  # noqa: E402

torch.set_num_threads(1)

GENERATE_CASES = {
    "production_full": dict(horizon_s=24.0, read_fault_every=11,
                            publish_crashes=1, preemptions=1),
    "production_smoke": dict(horizon_s=8.0, publish_crashes=1),
    "every_process_kind": dict(horizon_s=30.0, read_fault_every=9,
                               publish_crashes=2, preemptions=2,
                               cold_fetch_fails=3, nan_batches=4),
    "overload": dict(horizon_s=3.0, executor_slow_events=1,
                     executor_slow_ms=45.0, executor_slow_calls=30),
    "experiment": dict(horizon_s=12.0, challenger_nan_events=1,
                       challenger_nan_batches=2, challenger_slow_events=1,
                       challenger_slow_ms=250.0, challenger_stale_events=1),
    "after_rename_stage": dict(horizon_s=10.0, publish_crashes=1,
                               publish_crash_stage=(
                                   "after_rename_before_latest"),
                               challenger_slow_events=2,
                               challenger_slow_calls=5),
}


# Every variable a schedule reads or ``install`` writes (both packages').
CHAOS_ENV_KEYS = (faults.CHAOS_ENV, faults.CHAOS_STATE_ENV,
                  faults.READ_FAULT_ENV,
                  "DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS",
                  "DEEPFM_TPU_PREEMPT_AFTER_STEPS",
                  "DEEPFM_TPU_FAULT_AFTER_STEPS",
                  "DEEPFM_TPU_PREEMPT_HOLD_AFTER_STEPS")


@pytest.fixture
def clean_faults():
    """No env-carried chaos in, no armed seam out. ``install`` writes
    ``os.environ`` itself, so the variables are saved and restored here
    (a monkeypatch would put back what a test's ``install`` set)."""
    saved = {k: os.environ.pop(k) for k in CHAOS_ENV_KEYS
             if k in os.environ}
    yield
    for k in CHAOS_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(saved)
    for mod, fio in ((faults, fileio), (jax_faults, jax_fileio)):
        fio.set_fault_injector(None)
        mod.set_publish_crash("")
        mod.set_cold_fetch_plan(0)
        mod.take_nan_plan()


@pytest.mark.parametrize("seed", [0, 7, 11, 2026])
@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_json_and_fingerprint_equal(case, seed):
    kw = GENERATE_CASES[case]
    a = jax_faults.ChaosSchedule.generate(seed, **kw)
    b = faults.ChaosSchedule.generate(seed, **kw)
    assert b.to_json() == a.to_json()
    assert b.fingerprint() == a.fingerprint()
    # Each package reads the other's JSON back to the same plan.
    assert faults.ChaosSchedule.from_json(a.to_json()).to_json() \
        == a.to_json()
    assert jax_faults.ChaosSchedule.from_json(b.to_json()).fingerprint() \
        == b.fingerprint()


def test_kind_tables_and_env_names_equal():
    for name in ("PROCESS_KINDS", "DRIVER_KINDS", "ONESHOT_KINDS", "KINDS"):
        assert getattr(faults.ChaosSchedule, name) == \
            getattr(jax_faults.ChaosSchedule, name)
    assert (faults.CHAOS_ENV, faults.CHAOS_STATE_ENV,
            faults.READ_FAULT_ENV) == (jax_faults.CHAOS_ENV,
                                       jax_faults.CHAOS_STATE_ENV,
                                       jax_faults.READ_FAULT_ENV)
    with pytest.raises(ValueError, match="unknown chaos kind"):
        faults.ChaosSchedule([faults.ChaosEvent.make(0.0, "meteor_strike")])


def test_event_make_and_get_equal():
    a = jax_faults.ChaosEvent.make(1.23456, "preempt", b=2, a=1)
    b = faults.ChaosEvent.make(1.23456, "preempt", b=2, a=1)
    assert (b.at_s, b.kind, b.arg) == (a.at_s, a.kind, a.arg)
    assert b.get("a") == a.get("a") == 1
    assert b.get("missing", 5) == 5


def _write(tmp_path, text):
    p = tmp_path / "sched.json"
    p.write_text(text)
    return "@" + str(p)


@pytest.mark.parametrize("env", ["inline", "at_file", "legacy",
                                 "legacy_and_schedule", "none"])
def test_from_env_equal(tmp_path, env):
    sched = faults.ChaosSchedule.generate(5, **GENERATE_CASES[
        "every_process_kind"])
    environ = {
        "inline": {faults.CHAOS_ENV: sched.to_json()},
        "at_file": {faults.CHAOS_ENV: _write(tmp_path, sched.to_json())},
        "legacy": {faults.READ_FAULT_ENV: "7"},
        "legacy_and_schedule": {faults.CHAOS_ENV: sched.to_json(),
                                faults.READ_FAULT_ENV: "7"},
        "none": {},
    }[env]
    a = jax_faults.ChaosSchedule.from_env(environ)
    b = faults.ChaosSchedule.from_env(environ)
    if env == "none":
        assert a is None and b is None
        return
    assert b.to_json() == a.to_json()
    (ev,) = b.events_of("read_faults")
    assert ev.get("every") == (7 if env == "legacy" else 9)


def test_due_fires_drill_side_events_once():
    kw = dict(GENERATE_CASES["experiment"], preemptions=1,
              executor_slow_events=1, executor_slow_ms=5.0)
    a = jax_faults.ChaosSchedule.generate(3, **kw)
    b = faults.ChaosSchedule.generate(3, **kw)
    fa, fb = set(), set()
    for now in np.linspace(0.0, 13.0, 27):
        got_a = a.due(float(now), fa)
        got_b = b.due(float(now), fb)
        assert [(e.at_s, e.kind, e.arg) for e in got_b] == \
            [(e.at_s, e.kind, e.arg) for e in got_a]
    assert fb == fa and len(fb) == len(
        b.events_of(*faults.ChaosSchedule.DRIVER_KINDS))
    assert b.due(1e9, fb) == []                  # each fires once


def test_install_env_faults_arms_flakyfs_under_a_schedule(tmp_path,
                                                          clean_faults):
    """The repair: ``DEEPFM_TPU_CHAOS_SCHEDULE`` with a ``read_faults``
    event arms a ``FlakyFS`` in both packages, and the port's injects into
    the port's reads."""
    sched = faults.ChaosSchedule.generate(1, horizon_s=10.0,
                                          read_fault_every=2)
    os.environ[faults.CHAOS_ENV] = _write(tmp_path, sched.to_json())
    jfs = jax_faults.install_env_faults()
    pfs = faults.install_env_faults()
    assert isinstance(jfs, jax_faults.FlakyFS)
    assert isinstance(pfs, faults.FlakyFS)
    assert pfs.read_fail_every == jfs.read_fail_every == 2
    data = tmp_path / "blob.bin"
    data.write_bytes(b"x" * 64)
    with fileio.open_stream(str(data)) as f:
        f.read(8)
        with pytest.raises(faults.InjectedFault):
            f.read(8)
    assert pfs.injected_read_faults == 1


def test_install_env_faults_legacy_variable_still_works(clean_faults):
    os.environ[faults.READ_FAULT_ENV] = "3"
    pfs = faults.install_env_faults()
    assert isinstance(pfs, faults.FlakyFS) and pfs.read_fail_every == 3
    del os.environ[faults.READ_FAULT_ENV]
    fileio.set_fault_injector(None)
    assert faults.install_env_faults() is None


def test_install_oneshots_guarded_by_state_file(tmp_path, clean_faults):
    """A publish crash, cold-fetch failures and NaN batches arm once per
    state file; the state file lists the same keys as the JAX one's."""
    kw = dict(horizon_s=10.0, publish_crashes=1, cold_fetch_fails=2,
              nan_batches=2)
    states = {}
    for name, mod in (("jax", jax_faults), ("port", faults)):
        state = str(tmp_path / f"{name}_state.json")
        s = mod.ChaosSchedule.generate(1, **kw)
        s.install(state_path=state)
        with pytest.raises(mod.InjectedFault):
            mod.check_publish_crash("before_rename")
        for _ in range(2):
            with pytest.raises(mod.InjectedFault):
                mod.check_cold_fetch()
        mod.check_cold_fetch()                   # two armed, both spent
        assert mod.take_nan_plan()["batches"] == \
            s.events_of("nan_batches")[0].get("batches")
        # A supervised restart re-installs the same schedule: nothing
        # one-shot re-arms.
        s.install(state_path=state)
        mod.check_publish_crash("before_rename")
        mod.check_cold_fetch()
        assert mod.take_nan_plan() is None
        with open(state) as f:
            states[name] = json.load(f)
    assert states["port"] == states["jax"]
    assert len(states["port"]) == 3


def test_install_rearms_continuous_kinds(tmp_path, clean_faults):
    """Read faults and the step triggers re-arm at every start; the port's
    step triggers are the variables the port's train task reads."""
    events = [faults.ChaosEvent.make(0.0, "read_faults", every=4),
              faults.ChaosEvent.make(0.0, "preempt_after_steps", steps=7),
              faults.ChaosEvent.make(0.0, "fault_after_steps", steps=9),
              faults.ChaosEvent.make(0.0, "hold_after_steps", steps=11)]
    s = faults.ChaosSchedule(events, seed=1)
    state = str(tmp_path / "st.json")
    for _ in range(2):
        for k in ("DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS"):
            os.environ.pop(k, None)
        fs = s.install(state_path=state)
        assert isinstance(fs, faults.FlakyFS) and fs.read_fail_every == 4
        assert os.environ["DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS"] == "7"
        assert os.environ["DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS"] == "9"
        assert os.environ["DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS"] \
            == "11"
    assert not os.path.exists(state)      # no one-shot kind was armed
    from deepfm_tpu_torch.train import tasks
    assert (tasks.PREEMPT_AFTER_ENV, tasks.FAULT_AFTER_ENV,
            tasks.PREEMPT_HOLD_ENV) == (
        "DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS",
        "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS",
        "DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS")


# -- the supervisor ---------------------------------------------------------

SUPERVISE_CASES = {
    "clean": ([(1.0, 0)], {}),
    "preempt_backoff": ([(1.0, 42), (1.0, 43), (1.0, 0)],
                        dict(backoff_secs=1.0)),
    "crash_not_retried": ([(1.0, 1), (1.0, 0)], {}),
    "budget_exhausted": ([(1.0, 42)] * 10, dict(max_restarts=2,
                                                backoff_secs=0.5)),
    "healthy_resets": ([(100.0, 42)] * 5 + [(100.0, 0)],
                       dict(max_restarts=2, backoff_secs=1.0,
                            healthy_secs=50.0)),
    "short_runs": ([(1.0, 42)] * 10, dict(max_restarts=2, backoff_secs=0.0,
                                          healthy_secs=50.0)),
    "total_cap": ([(100.0, 42)] * 10, dict(max_restarts=2, backoff_secs=0.0,
                                           healthy_secs=50.0,
                                           max_total_restarts=4)),
    "histogram": ([(1.0, 42), (1.0, 43), (1.0, 1)], {}),
}


def _supervised(fn, runs, kw):
    seq = list(runs)
    t = [0.0]
    sleeps, logs = [], []

    def spawn(cmd):
        secs, rc = seq.pop(0)
        t[0] += secs
        return rc

    rc = fn(["train"], spawn=spawn, sleep=sleeps.append, log=logs.append,
            clock=lambda: t[0], **kw)
    return rc, sleeps, logs, len(seq)


@pytest.mark.parametrize("case", sorted(SUPERVISE_CASES))
def test_run_supervised_matches_jax(case):
    """Exit code, backoff sleeps, log lines and the runs left are the JAX
    supervisor's, on the same exit sequence."""
    runs, kw = SUPERVISE_CASES[case]
    assert _supervised(supervise.run_supervised, runs, kw) == \
        _supervised(jax_supervise.run_supervised, runs, kw)


def test_supervise_main_runs_a_command():
    rc = supervise.main(["--max_restarts", "1", "--backoff_secs", "0", "--",
                         sys.executable, "-c", "import sys; sys.exit(0)"])
    assert rc == 0
    rc = supervise.main(["--max_restarts", "1", "--backoff_secs", "0", "--",
                         sys.executable, "-c", "import sys; sys.exit(42)"])
    assert rc == 42


def test_no_chaos_variable_left_behind():
    """The tests above restore every variable a schedule writes: a leaked
    step trigger would preempt the next train task in this worker."""
    assert [k for k in CHAOS_ENV_KEYS if k in os.environ] == []
