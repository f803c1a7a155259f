"""The port's fault, preemption and online drills
(``deepfm_tpu_torch.drills.{fault,preempt,online}``) on the CPU at the JAX
drills' model, held against the JAX drills (``scripts/*_drill.py``), and
the hold sentinel they wait on.

The sentinel is written atomically, so a reader polling for it never reads
it empty. The fault drill's datasets are byte-identical to the JAX drill's
and its clean run ends within float32 tolerance of a JAX ``tasks.run``
from the same init. The fault and online drills run whole here; the
preemption drill runs its staged path here and both paths under ``slow``
(about 35 s: eight launcher subprocesses), as the JAX package marks its
drills.
"""

import json
import os
import shutil
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.train import Trainer as JaxTrainer
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm, tfrecord
from deepfm_tpu_torch.drills import fault, online, preempt, supervise
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import faults
from deepfm_tpu_torch.utils import preempt as preempt_lib
from deepfm_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "scripts"))
import fault_drill as jax_fault_drill  # noqa: E402
import online_drill as jax_online_drill  # noqa: E402
import preempt_drill as jax_preempt_drill  # noqa: E402

# tests/test_torch_train.py's float32 tolerance, dropout off.
F32_PARAM_ATOL = 2e-6


@pytest.fixture(autouse=True)
def _clean_listener():
    yield
    preempt_lib.get_listener().clear()


def _steps(num_files, per_file, epochs, batch=16):
    return num_files * per_file // batch * epochs


# -- the hold sentinel ------------------------------------------------------

HOLDS = 16


def test_hold_sentinel_is_never_read_empty(tmp_path, monkeypatch):
    """Across many holds, a reader thread that opens the sentinel the
    moment it appears reads the step, never an empty file, even with the
    interpreter switching threads every microsecond."""
    data = str(tmp_path / "data")
    libsvm.generate_synthetic_ctr(data, num_files=1, examples_per_file=64,
                                  feature_size=64, field_size=5, seed=5)
    monkeypatch.setenv(tasks.PREEMPT_HOLD_ENV, "2")
    reads = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(HOLDS):
            cfg = fault._cfg(data, str(tmp_path / f"ckpt{i}"), num_epochs=1,
                             steps_per_loop=1)
            sentinel = os.path.join(cfg.model_dir, ".preempt_hold")
            out = {}

            def run(cfg=cfg, out=out):
                try:
                    tasks.run(cfg, device="cpu")
                except preempt_lib.Preempted as e:
                    out["step"] = e.step

            t = threading.Thread(target=run)
            t.start()
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    with open(sentinel, encoding="utf-8") as f:
                        reads.append(f.read())
                    break
                except FileNotFoundError:
                    pass
            preempt_lib.get_listener().trigger("drill signal")
            t.join(60)
            preempt_lib.get_listener().clear()
            assert out == {"step": 2}
            assert not [n for n in os.listdir(cfg.model_dir)
                        if ".tmp." in n]
    finally:
        sys.setswitchinterval(old)
    assert reads == ["2"] * HOLDS


# -- the fault drill --------------------------------------------------------

def test_build_datasets_match_jax(tmp_path):
    ours = fault.build_datasets(str(tmp_path / "port"))
    theirs = jax_fault_drill.build_datasets(str(tmp_path / "jax"))
    assert os.path.basename(ours[2]) == os.path.basename(theirs[2])
    assert ours[3] == theirs[3]
    for a, b in zip(ours[:2], theirs[:2]):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and len(names) == 4
        for n in names:
            with open(os.path.join(a, n), "rb") as fa, \
                    open(os.path.join(b, n), "rb") as fb:
                assert fa.read() == fb.read(), n
    clean = os.path.join(ours[0], os.path.basename(ours[2]))
    assert fault.frame_offsets(clean) == jax_fault_drill.frame_offsets(clean)
    assert len(tfrecord.read_all_records(clean)) == \
        fault.RECORDS_PER_FILE - 1


def test_clean_run_matches_jax_tasks_run(tmp_path):
    """The fault drill's clean run from JAX's init (a step-0 checkpoint)
    ends within float32 tolerance of the JAX drill's clean ``tasks.run``."""
    clean, _, _, _ = fault.build_datasets(str(tmp_path))
    jcfg = jax_fault_drill._cfg(clean, str(tmp_path / "jax_ckpt"))
    jax_tasks.run(jcfg)
    jparams, jstep = jax_fault_drill.final_params(jcfg)

    cfg = fault._cfg(clean, str(tmp_path / "ckpt"))
    js = JaxTrainer(jcfg).init_state()
    trainer = Trainer(cfg, device="cpu")
    state = trainer.load_weights(trainer.init_state(), *params_from_jax(
        jax.tree.map(np.asarray, js.params),
        jax.tree.map(np.asarray, js.model_state)))
    mgr = ckpt_lib.CheckpointManager(cfg.model_dir)
    mgr.save(0, state, force=True)
    mgr.close()
    res = tasks.run(cfg, device="cpu")
    params, step = fault.final_params(cfg, "cpu")
    assert res["steps"] == step == jstep == _steps(
        1, fault.NUM_FILES * fault.RECORDS_PER_FILE - 1, 2)
    want, _ = params_from_jax(jparams, {})
    assert set(want) == set(params)
    for key, ref in want.items():
        np.testing.assert_allclose(params[key], ref.numpy(), rtol=0,
                                   atol=F32_PARAM_ATOL, err_msg=key)


def test_assert_tree_equal_names_the_key_and_the_difference():
    a = {"w": np.zeros(3, np.float32), "v": np.ones(2, np.float32)}
    fault.assert_tree_equal(a, {k: v.copy() for k, v in a.items()}, "same")
    b = {"w": np.array([0, 0.5, 0], np.float32), "v": a["v"]}
    with pytest.raises(AssertionError, match=r"'w' differs .*0\.5"):
        fault.assert_tree_equal(a, b, "one off")
    with pytest.raises(AssertionError, match="keys differ"):
        fault.assert_tree_equal(a, {"w": a["w"]}, "missing")


def test_flaky_saves_are_patched_only_inside_the_context(tmp_path):
    original = ckpt_lib.CheckpointManager._do_save
    cfg = fault._cfg("", str(tmp_path / "c"))
    state = Trainer(cfg, device="cpu").init_state()
    mgr = ckpt_lib.CheckpointManager(cfg.model_dir, async_save=False)
    with faults.FlakyFS(save_failures=1) as fs:
        assert ckpt_lib.CheckpointManager._do_save is not original
        assert mgr.save(1, state) is False  # deferred, within budget
        assert mgr.save(2, state) is True
    assert ckpt_lib.CheckpointManager._do_save is original
    assert fs.injected_save_faults == 1 and mgr.save_failures == 1
    assert mgr.all_steps() == [2]
    mgr.close()


def test_fault_drill_end_to_end(tmp_path):
    """All four parts at the JAX drill's model; the counts the JAX drill
    asserts: every injected read fault healed, one skip per pass over the
    faulty dir, the raise policy's path and offset, one save fault."""
    s = fault.run_drill(str(tmp_path), verbose=False, device="cpu")
    epochs = jax_fault_drill._cfg("", "").num_epochs
    assert s["steps"] == _steps(
        1, jax_fault_drill.NUM_FILES * jax_fault_drill.RECORDS_PER_FILE - 1,
        epochs)
    assert s["bad_records"] == 2 * epochs
    assert s["read_faults_injected"] == s["read_faults_healed"]["staged"] > 0
    assert s["read_faults_healed"]["decoded_cache"] > 0
    assert s["read_faults_healed"]["device_dataset"] > 0
    assert s["save_faults_injected"] == 1 and s["runs"] == 7
    victim = jax_fault_drill.build_datasets(str(tmp_path / "jax"))
    assert s["victim"] == [os.path.basename(victim[2]), victim[3]]


def test_fault_drill_main(tmp_path, capsys):
    assert fault.main(["--device", "cpu", "--workdir",
                       str(tmp_path)]) == 0
    assert "[fault_drill] PASS" in capsys.readouterr().out


# -- the drills' subprocess trainer ------------------------------------------

def test_child_env_drops_the_trigger_variables(monkeypatch):
    names = (tasks.PREEMPT_HOLD_ENV, tasks.PREEMPT_AFTER_ENV,
             tasks.FAULT_AFTER_ENV, faults.READ_FAULT_ENV,
             faults.CHAOS_ENV, faults.CHAOS_STATE_ENV)
    assert set(supervise.CHILD_ENV_DROP) == set(names)
    for n in names:
        monkeypatch.setenv(n, "3")
    env = supervise.child_env(**{tasks.PREEMPT_AFTER_ENV: 4})
    assert env[tasks.PREEMPT_AFTER_ENV] == "4"
    assert not [n for n in names if n in env and n != tasks.PREEMPT_AFTER_ENV]
    assert env["PYTHONPATH"].split(os.pathsep)[0] == supervise.REPO_ROOT


def test_launcher_cmd():
    flags = {"task_type": "train", "online_mode": True, "batch_size": 16}
    card = supervise.launcher_cmd(flags, "cuda")
    assert card[1:3] == ["-m", "deepfm_tpu_torch.launch"]
    assert card[3:] == ["--task_type", "train", "--online_mode", "1",
                        "--batch_size", "16"]
    cpu = supervise.launcher_cmd(flags, torch.device("cpu"))
    assert cpu[1] == "-c" and "device='cpu'" in cpu[2]
    assert cpu[3:] == card[3:]


# -- the preemption drill ----------------------------------------------------

def _preempt_expect():
    """The counts the JAX preemption drill's constants give: the steps, and
    the supervised relaunches that preempt themselves before the end."""
    steps = _steps(jax_preempt_drill.NUM_FILES,
                   jax_preempt_drill.RECORDS_PER_FILE, 2)
    hold, every = (jax_preempt_drill.HOLD_AFTER_STEPS,
                   jax_preempt_drill.RESUME_PREEMPT_EVERY)
    restarts = len(range(hold + every, steps, every))
    return {"steps": steps, "subprocesses": 2 + restarts,
            "restarts": restarts, "exit_42": 1 + restarts}


def test_preempt_drill_staged_path(tmp_path):
    """The staged path: the held subprocess exits 42 at the sentinel, the
    supervisor restarts the self-preempting relaunches, and the final
    params equal the uninterrupted baseline's bit for bit."""
    assert (preempt.HOLD_AFTER_STEPS, preempt.RESUME_PREEMPT_EVERY) == (
        jax_preempt_drill.HOLD_AFTER_STEPS,
        jax_preempt_drill.RESUME_PREEMPT_EVERY)
    s = preempt.run_drill(str(tmp_path), device="cpu", verbose=False,
                          paths=preempt.PATHS[:1])
    assert s["staged"] == _preempt_expect()


@pytest.mark.slow
def test_preempt_drill_end_to_end(tmp_path):
    s = preempt.run_drill(str(tmp_path), device="cpu", verbose=False)
    assert s["staged"] == s["device"] == _preempt_expect()


# -- the online drill --------------------------------------------------------

def test_feed_is_an_atomic_rename(tmp_path, monkeypatch):
    """A shard lands under a hidden name that no ``tr*.tfrecords`` listing
    matches, then one rename puts it in place whole."""
    src = tmp_path / "src" / "tr_0000.tfrecords"
    src.parent.mkdir()
    src.write_bytes(b"x" * 4096)
    live = tmp_path / "live"
    live.mkdir()
    seen = []
    real = os.replace

    def replace(a, b):
        seen.append((os.path.basename(a), os.path.basename(b),
                     sorted(os.listdir(live))))
        real(a, b)

    monkeypatch.setattr(os, "replace", replace)
    online._feed(str(src), str(live))
    assert seen == [(".tr_0000.tfrecords.part", "tr_0000.tfrecords",
                     [".tr_0000.tfrecords.part"])]
    assert os.listdir(live) == ["tr_0000.tfrecords"]
    assert (live / "tr_0000.tfrecords").read_bytes() == src.read_bytes()


def test_audit_publish_dir_on_a_clean_online_run(tmp_path):
    """A clean online run's publish dir passes the audit with the versions
    the run published; a torn artifact and a leaked staging dir fail it."""
    src = tmp_path / "src"
    shards = sorted(libsvm.generate_synthetic_ctr(
        str(src), num_files=2, examples_per_file=48, feature_size=64,
        field_size=5, prefix="tr", seed=5))
    data = tmp_path / "data"
    data.mkdir()
    for p in shards:
        online._feed(p, str(data))
    flags = online._flags(str(data), str(tmp_path / "ckpt"))
    res = tasks.run(Config(**flags), device="cpu")
    pdir = str(tmp_path / "ckpt" / "publish")
    versions = online._audit_publish_dir(pdir, lambda m: None)
    assert sorted(versions) == res["published_versions"] == [4, 6]
    # The JAX drill's audit passes the same dir's layout check up to its
    # Orbax load, which the port's artifacts do not carry.
    broken = str(tmp_path / "broken")
    shutil.copytree(pdir, broken)
    os.remove(os.path.join(broken, "4", export_lib.COMPLETE_MARKER))
    with pytest.raises(export_lib.ArtifactIncomplete):
        online._audit_publish_dir(broken, lambda m: None)
    leaked = str(tmp_path / "leaked")
    shutil.copytree(pdir, leaked)
    os.makedirs(os.path.join(leaked, ".staging-8-1"))
    with pytest.raises(AssertionError, match="leaked"):
        online._audit_publish_dir(leaked, lambda m: None)
    params = online.artifact_params(versions[4])
    with open(os.path.join(versions[4], "model_config.json")) as f:
        assert json.load(f)["step"] == 4
    assert set(params) >= {"fm_w", "fm_v"}


def test_online_drill_end_to_end(tmp_path):
    """All four parts at the JAX drill's model: exit 42 under read faults,
    the supervised relaunches, every shard admitted in order, the audit,
    and bit-equal versions against a clean replay. The steps, the
    restarts and the cadence's versions are the ones the JAX drill's
    constants give; as there, a cadence that falls while a publish is in
    flight is skipped (host speed decides which), so both runs hold the
    final version and every shared version is bit-equal."""
    s = online.run_drill(str(tmp_path), device="cpu", verbose=False)
    j = jax_online_drill
    steps = _steps(j.NUM_FILES, j.RECORDS_PER_FILE, 1)
    versions = list(range(j.PUBLISH_EVERY_STEPS, steps + 1,
                          j.PUBLISH_EVERY_STEPS))
    restarts = len(range(j.HOLD_AFTER_STEPS + j.RESUME_PREEMPT_EVERY,
                         steps, j.RESUME_PREEMPT_EVERY))
    assert s["steps"] == steps and s["shards_admitted"] == j.NUM_FILES
    for run in ("versions_live", "versions_clean"):
        assert set(s[run]) <= set(versions) and s[run][-1] == steps, run
    assert s["versions_bit_equal"] == len(
        set(s["versions_live"]) & set(s["versions_clean"])) >= 1
    assert s["restarts"] == restarts and s["exit_42"] == 1 + restarts
    assert s["subprocesses"] == 2 + restarts
