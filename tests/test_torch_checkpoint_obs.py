"""Asynchronous checkpoints, TensorBoard summaries and the profiler's step
window in the port, on the CPU.

Interval saves land on a background thread from a host copy taken at the
save: a crashed and resumed run ends bit-identical (tolerance: none) to
the same run with synchronous saves and to an uninterrupted run; the
resume sidecar never names a checkpoint that did not land; failed interval
saves are deferred up to ``max_save_failures`` in a row. The TensorBoard
writer is handed the same scalar names at the same steps as the JAX
package's (both given a recording fake). ``StepWindowTracer`` writes a
Chrome trace of its window.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.obs.tensorboard import TensorBoardWriter
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import preempt as preempt_lib
from deepfm_tpu_torch.utils.profiling import StepWindowTracer

torch.set_num_threads(1)

V, F = 300, 5


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt_obs"))
    libsvm.generate_synthetic_ctr(d, num_files=2, examples_per_file=160,
                                  feature_size=V, field_size=F, seed=41)
    libsvm.generate_synthetic_ctr(d, num_files=1, examples_per_file=64,
                                  feature_size=V, field_size=F, seed=42,
                                  prefix="va")
    return d


def _kw(data_dir, model_dir, **kw):
    base = dict(task_type="train", feature_size=V, field_size=F,
                embedding_size=4, deep_layers="8", dropout="1.0",
                batch_size=16, learning_rate=0.01, log_steps=4,
                steps_per_loop=2, num_epochs=2, shuffle_buffer=100,
                data_dir=data_dir, model_dir=str(model_dir),
                save_checkpoints_steps=6, seed=9)
    base.update(kw)
    return base


def _final(model_dir):
    steps = sorted(int(n[5:-3]) for n in os.listdir(model_dir)
                   if n.startswith("ckpt-"))
    return torch.load(os.path.join(model_dir, f"ckpt-{steps[-1]}.pt"),
                      weights_only=True)


def _same(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "model_state"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    assert torch.equal(a["rng"], b["rng"])


def _crash_and_resume(data_dir, model_dir, monkeypatch, after=9):
    cfg = Config(**_kw(data_dir, model_dir))
    monkeypatch.setenv(tasks.FAULT_AFTER_ENV, str(after))
    with pytest.raises(RuntimeError, match="fault injection"):
        tasks.run(cfg, device="cpu")
    monkeypatch.delenv(tasks.FAULT_AFTER_ENV)
    tasks.run(cfg, device="cpu")
    return _final(model_dir)


def test_async_saves_resume_as_sync_saves(data_dir, tmp_path, monkeypatch):
    clean = str(tmp_path / "clean")
    tasks.run(Config(**_kw(data_dir, clean)), device="cpu")
    async_run = _crash_and_resume(data_dir, tmp_path / "async", monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(tasks.ckpt_lib, "CheckpointManager", functools.partial(
            ckpt_lib.CheckpointManager, async_save=False))
        sync_run = _crash_and_resume(data_dir, tmp_path / "sync",
                                     monkeypatch)
    want = _final(clean)
    assert want["step"] == 2 * (320 // 16)
    _same(async_run, want)
    _same(sync_run, want)


def _failing_saves(monkeypatch, steps):
    orig = ckpt_lib.CheckpointManager._do_save

    def do_save(self, step, snapshot):
        if step in steps:
            raise OSError(f"injected save failure at step {step}")
        return orig(self, step, snapshot)
    monkeypatch.setattr(ckpt_lib.CheckpointManager, "_do_save", do_save)


def test_failed_interval_saves_are_deferred(data_dir, tmp_path, monkeypatch):
    _failing_saves(monkeypatch, {6, 12})
    res = tasks.run(Config(**_kw(data_dir, tmp_path / "m")), device="cpu")
    assert res["save_failures"] == 2 and res["steps"] == 40
    steps = sorted(int(n[5:-3]) for n in os.listdir(tmp_path / "m")
                   if n.startswith("ckpt-"))
    assert 6 not in steps and 12 not in steps and steps[-1] == 40


def test_consecutive_save_failures_abort(data_dir, tmp_path, monkeypatch):
    _failing_saves(monkeypatch, {6, 12, 18})
    with pytest.raises(IOError, match="max_save_failures=1"):
        tasks.run(Config(**_kw(data_dir, tmp_path / "m",
                               max_save_failures=1)), device="cpu")


def test_sidecar_names_only_durable_checkpoints(tmp_path, monkeypatch):
    """A failed async save never gets its sidecar; the next one that lands
    does, after its checkpoint file exists."""
    cfg = Config(feature_size=V, field_size=F, embedding_size=4,
                 deep_layers="8", batch_size=16)
    state = Trainer(cfg, device="cpu").init_state()
    failing = {3}
    _failing_saves(monkeypatch, failing)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), max_save_failures=2)
    written = []

    def sidecar(step):
        assert os.path.exists(mgr._path(step))
        written.append(step)

    for step in (3, 5):
        state.step = step
        assert mgr.save(step, state, on_saved=functools.partial(sidecar,
                                                                step))
    mgr.wait()
    assert written == [5] and mgr.save_failures == 1
    assert mgr.all_steps() == [5]
    failing.clear()
    state.step = 3  # a forced save of the failed step writes it now
    assert mgr.save(3, state, force=True)
    assert mgr.all_steps() == [3, 5]
    mgr.close()


def test_interval_save_copies_before_the_next_step(tmp_path):
    """The save's host copy is complete when save() returns: an in-place
    update right after it does not reach the checkpoint."""
    cfg = Config(feature_size=V, field_size=F, embedding_size=4,
                 deep_layers="8", batch_size=16)
    state = Trainer(cfg, device="cpu").init_state()
    want = {k: v.detach().clone() for k, v in state.params.items()}
    mgr = ckpt_lib.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    with torch.no_grad():
        for v in state.params.values():
            v.mul_(3.0)
    mgr.close()
    got = torch.load(mgr._path(1), weights_only=True)["params"]
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_restore_reads_through_the_retry_policy(tmp_path, monkeypatch):
    from deepfm_tpu_torch.utils import retry as retry_lib
    cfg = Config(feature_size=V, field_size=F, embedding_size=4,
                 deep_layers="8", batch_size=16)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    state.step = 4
    mgr = ckpt_lib.CheckpointManager(
        str(tmp_path), retry_policy=retry_lib.RetryPolicy(
            base_delay=0.0, max_delay=0.0))
    mgr.save(4, state, force=True)
    real_load, fails = torch.load, [2]

    def flaky_load(*a, **k):
        if fails[0]:
            fails[0] -= 1
            raise OSError("transient read fault")
        return real_load(*a, **k)
    monkeypatch.setattr(torch, "load", flaky_load)
    assert mgr.restore(trainer.init_state()).step == 4
    assert fails[0] == 0
    mgr.close()


# -- TensorBoard --------------------------------------------------------------

class RecordingWriter:
    """Stands in for both packages' writers: records (step, name)."""

    def __init__(self, logdir, calls):
        self.calls = calls

    def scalars(self, step, **values):
        self.calls += [(int(step), name) for name in values]

    def scalar_dict(self, step, prefix, values):
        self.calls += [(int(step), prefix + name)
                       for name, v in values.items()
                       if not isinstance(v, bool)
                       and isinstance(v, (int, float))]

    def close(self):
        pass


@pytest.mark.parametrize("mode", ["file", "online"])
def test_tensorboard_scalars_as_jax(data_dir, tmp_path, monkeypatch, mode):
    monkeypatch.setattr(jax_export, "_export_tf_savedmodel",
                        lambda *a, **k: None)
    extra = dict(tensorboard_dir=str(tmp_path / "tb"))
    if mode == "online":
        extra.update(pipe_mode=1, online_mode=True, num_epochs=1,
                     publish_every_steps=0, publish_every_secs=3600.0,
                     stream_poll_secs=0.05, stream_idle_timeout_secs=0.5,
                     save_checkpoints_steps=0)
    port_calls, jax_calls = [], []
    monkeypatch.setattr(tasks, "TensorBoardWriter",
                        lambda d: RecordingWriter(d, port_calls))
    monkeypatch.setattr(jax_tasks, "_TensorBoardWriter",
                        lambda d: RecordingWriter(d, jax_calls))
    tasks.run(Config(**_kw(data_dir, tmp_path / "p", **extra)),
              device="cpu")
    jax_tasks.run(JaxConfig(**_kw(
        data_dir, tmp_path / "j", compute_dtype="float32", mesh_data=1,
        scale_lr_by_world=False, **extra)))
    preempt_lib.get_listener().clear()
    assert port_calls == jax_calls
    names = {name for _, name in port_calls}
    assert {"loss", "examples_per_sec", "eval_auc"} <= names
    assert any(n.startswith("health/") for n in names)
    if mode == "online":
        assert "publish/publish_count" in names


def test_tensorboard_writer_writes_event_files(tmp_path):
    w = TensorBoardWriter(str(tmp_path / "tb"))
    if not w.enabled:  # the tensorboard package does not import here
        assert not os.path.exists(tmp_path / "tb")
        return
    w.scalars(3, loss=0.5)
    w.scalar_dict(3, "publish/", {"n": 2, "who": "x", "v": None})
    w.close()
    assert any(n.startswith("events.out.tfevents")
               for n in os.listdir(tmp_path / "tb"))


def test_tensorboard_writer_is_a_noop_without_a_dir():
    w = TensorBoardWriter("")
    w.scalars(1, loss=1.0)
    w.close()
    assert not w.enabled


# -- the profiler's step window ---------------------------------------------

def test_step_window_tracer_writes_a_trace(tmp_path):
    tracer = StepWindowTracer(str(tmp_path), start_step=2, num_steps=3)
    x = torch.randn(64, 64)
    for _ in range(8):
        with torch.profiler.record_function("dfm_step"):
            x = torch.tanh(x @ x)
        tracer.on_step(1)
    tracer.close()
    assert tracer.trace_path and os.path.exists(tracer.trace_path)
    events = json.load(open(tracer.trace_path))["traceEvents"]
    assert any(e.get("name") == "dfm_step" for e in events)
    # One window only: later steps do not open another.
    assert len(os.listdir(tmp_path)) == 1


def test_profile_dir_task_writes_a_trace(data_dir, tmp_path):
    prof = tmp_path / "prof"
    res = tasks.run(Config(**_kw(data_dir, tmp_path / "m",
                                 profile_dir=str(prof), profile_steps=4,
                                 num_epochs=1)), device="cpu")
    assert np.isfinite(res["loss"])
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.load(open(prof / traces[0]))["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
