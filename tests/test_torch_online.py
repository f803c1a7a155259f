"""The port's online trainer on the CPU, mirroring tests/test_online_mode.py:
continuous training from a growing directory with hot publishing, the
JAX package's online run as the reference for steps and published versions,
pipe mode over the final shard set as the reference for the tables, a
preempted and resumed run against a clean one, the windowed AUC and the
throttled eval's cadence against the JAX package's, and the config's
refusals. Tables, versions and windowed-AUC histograms are compared
exactly; the windowed AUC itself within 1e-6 (a float32 sum in another
order).
"""

import json
import os

import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.train import metrics as jax_metrics
from deepfm_tpu.train import publish as jax_publish
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.train import metrics, publish, tasks
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import preempt as preempt_lib

torch.set_num_threads(1)

FEATURE_SIZE = 64
FIELD_SIZE = 5
RECORDS_PER_FILE = 48  # batch 16 -> 3 steps per shard


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(jax_export, "_export_tf_savedmodel",
                        lambda *a, **k: None)
    preempt_lib.get_listener().clear()
    yield
    preempt_lib.get_listener().clear()


def _make_shards(data_dir, num_files, seed=5, prefix="tr"):
    return sorted(libsvm.generate_synthetic_ctr(
        str(data_dir), num_files=num_files,
        examples_per_file=RECORDS_PER_FILE, feature_size=FEATURE_SIZE,
        field_size=FIELD_SIZE, prefix=prefix, seed=seed))


def _kw(data_dir, model_dir, **kw):
    base = dict(
        task_type="train", data_dir=str(data_dir), model_dir=str(model_dir),
        feature_size=FEATURE_SIZE, field_size=FIELD_SIZE, embedding_size=4,
        deep_layers="8", dropout="1.0", batch_size=16, num_epochs=1,
        log_steps=0, seed=17, verify_crc=True, save_checkpoints_steps=0,
        io_retry_backoff_secs=0.0, pipe_mode=1, online_mode=True,
        steps_per_loop=1, publish_every_steps=2, stream_poll_secs=0.05,
        stream_idle_timeout_secs=1.0)
    base.update(kw)
    return base


def _cfg(data_dir, model_dir, **kw):
    return Config(**_kw(data_dir, model_dir, **kw))


def _final(model_dir):
    steps = sorted(int(n[5:-3]) for n in os.listdir(model_dir)
                   if n.startswith("ckpt-"))
    return torch.load(os.path.join(model_dir, f"ckpt-{steps[-1]}.pt"),
                      weights_only=True)


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "model_state"):
        assert set(a[part]) == set(b[part])
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)


def _publish_synchronously(monkeypatch):
    """Each publish lands before the next dispatch on both sides, so no
    cadence is skipped for being busy (that depends on the host's speed)
    and the versions are a function of the steps alone."""
    for mod in (publish, jax_publish):
        orig = mod.Publisher.maybe_publish

        def maybe_publish(self, state, step, orig=orig):
            started = orig(self, state, step)
            self.drain()
            return started
        monkeypatch.setattr(mod.Publisher, "maybe_publish", maybe_publish)


def test_online_run_publishes_as_jax(tmp_path, monkeypatch):
    _publish_synchronously(monkeypatch)
    data = tmp_path / "data"
    _make_shards(data, 2)
    res = tasks.run(_cfg(data, tmp_path / "ckpt"), device="cpu")
    jax_res = jax_tasks.run(JaxConfig(**_kw(
        data, tmp_path / "jax_ckpt", compute_dtype="float32", mesh_data=1,
        scale_lr_by_world=False)))
    assert res["steps"] == jax_res["steps"] == 6
    versions = res["published_versions"]
    assert versions == jax_res["published_versions"]
    assert versions[-1] == 6 and versions == sorted(set(versions))
    assert res["publish_failures"] == 0

    publish_dir = str(tmp_path / "ckpt" / "publish")
    assert not [n for n in os.listdir(publish_dir) if n.startswith(".")]
    for v in versions:
        probs = export_lib.load_serving(os.path.join(publish_dir, str(v)),
                                        device="cpu")(
            np.zeros((2, FIELD_SIZE), np.int32),
            np.ones((2, FIELD_SIZE), np.float32))
        assert np.all(np.isfinite(probs))
    latest = export_lib.read_latest(publish_dir)
    assert int(os.path.basename(latest)) == max(versions)
    assert [e["version"] for e in export_lib.pointer_history(publish_dir)] \
        == [str(v) for v in versions]

    # The high-water-mark sidecar holds the same admissions as the JAX
    # package's.
    metas = [json.load(open(tmp_path / d / "stream_manifest.json"))
             for d in ("ckpt", "jax_ckpt")]
    assert metas[0] == metas[1] and len(metas[0]["admitted"]) == 2


def test_online_equals_pipe_mode_over_the_final_shards(tmp_path):
    data = tmp_path / "data"
    _make_shards(data, 3)
    tasks.run(_cfg(data, tmp_path / "online"), device="cpu")
    tasks.run(_cfg(data, tmp_path / "pipe", online_mode=False,
                   shuffle_files=False, publish_every_steps=0),
              device="cpu")
    a, b = _final(tmp_path / "online"), _final(tmp_path / "pipe")
    assert a["step"] == 9
    _assert_same_state(a, b)


def test_preempt_resume_trains_each_record_once(tmp_path, monkeypatch):
    _publish_synchronously(monkeypatch)
    data = tmp_path / "data"
    shards = _make_shards(data, 4)
    # Hide the back half: it arrives after the preemption.
    hidden = [p + ".hold" for p in shards[2:]]
    for src, dst in zip(shards[2:], hidden):
        os.rename(src, dst)
    live = _cfg(data, tmp_path / "ckpt")
    monkeypatch.setenv(tasks.PREEMPT_AFTER_ENV, "3")
    with pytest.raises(preempt_lib.Preempted):
        tasks.run(live, device="cpu")
    monkeypatch.delenv(tasks.PREEMPT_AFTER_ENV)
    preempt_lib.get_listener().clear()
    for src, dst in zip(hidden, shards[2:]):
        os.rename(src, dst)
    res = tasks.run(live, device="cpu")
    assert res["steps"] == 12  # 4 shards x 3 batches across both runs
    clean = _cfg(data, tmp_path / "ckpt_clean")
    tasks.run(clean, device="cpu")
    a, b = _final(tmp_path / "ckpt"), _final(tmp_path / "ckpt_clean")
    assert a["step"] == 12
    _assert_same_state(a, b)
    # The resumed run republished the clean run's versions.
    pub = [sorted(int(n) for n in os.listdir(tmp_path / d / "publish")
                  if n.isdigit()) for d in ("ckpt", "ckpt_clean")]
    assert pub[0] == pub[1] and pub[0][-1] == 12


def test_windowed_eval_reported(tmp_path):
    data = tmp_path / "data"
    _make_shards(data, 2)
    _make_shards(data, 1, seed=8, prefix="va")
    res = tasks.run(_cfg(data, tmp_path / "ckpt",
                         online_eval_window_steps=8), device="cpu")
    assert 0.0 < res["auc"] <= 1.0
    assert res["window_examples"] == RECORDS_PER_FILE


@pytest.mark.parametrize("window,bins", [(3, 200), (8, 50), (1, 7)])
def test_windowed_auc_equals_jax(window, bins):
    rng = np.random.default_rng(window * 100 + bins)
    port = metrics.WindowedAuc(window, num_bins=bins)
    jax_side = jax_metrics.WindowedAuc(window, num_bins=bins)
    for step in (1, 2, 2, 4, 5, 9, 10, 16):
        n = int(rng.integers(5, 40))
        p = rng.random(n)
        y = (rng.random(n) < p).astype(np.float64)
        port.update(step, p, y)
        jax_side.update(step, p, y)
        assert port.examples == jax_side.examples
        got, want = port.compute(), jax_side.compute()
        # The histograms are equal; the AUC's float32 trapezoid sum is
        # reduced in another order by XLA (tolerance 1e-6, as for the
        # batch AUC in test_torch_train.py).
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) < 1e-6
        for g, w in zip(port.histograms(), jax_side.histograms()):
            np.testing.assert_array_equal(g, w)


def test_windowed_auc_empty_is_nan():
    assert np.isnan(metrics.WindowedAuc(4).compute())
    with pytest.raises(ValueError, match="window_steps"):
        metrics.WindowedAuc(0)


@pytest.mark.parametrize("delay,throttle", [(0, 5), (7, 0), (3, 4)])
def test_throttled_eval_cadence_equals_jax(monkeypatch, delay, throttle):
    """The same clock readings make both hooks evaluate at the same
    dispatches (time.time is replaced by one scripted clock)."""
    import time as time_mod
    real_time = time_mod.time
    ticks = [0.0, 1.0, 2.5, 3.0, 4.0, 6.0, 6.5, 9.0, 12.0, 13.0, 20.0, 21.0]
    evaluated = {}
    for name, mod, cfg in (
            ("port", tasks, Config(eval_start_delay_secs=delay,
                                   eval_throttle_secs=throttle)),
            ("jax", jax_tasks, JaxConfig(eval_start_delay_secs=delay,
                                         eval_throttle_secs=throttle))):
        now = [0.0]
        monkeypatch.setattr(time_mod, "time", lambda: now[0])
        seen = []
        result = {}
        hook = mod._make_throttled_eval_hook(
            None, cfg, [], result,
            evaluate=lambda s, seen=seen: (seen.append(now[0]) or
                                           {"auc": 0.5, "loss": 1.0,
                                            "examples_per_sec": 1.0}))
        state = type("S", (), {"step": 0})()
        for t in ticks:
            now[0] = t
            hook(state, {"steps_done": 1})
        monkeypatch.setattr(time_mod, "time", real_time)
        evaluated[name] = (seen, result["mid_train_evals"])
    assert evaluated["port"] == evaluated["jax"]
    assert evaluated["port"][1] >= 1


class TestConfigValidation:
    def test_online_mode_requires_pipe_mode(self, tmp_path):
        with pytest.raises(ValueError, match="online_mode"):
            _cfg(tmp_path, tmp_path / "c", pipe_mode=0)

    def test_online_mode_requires_single_epoch(self, tmp_path):
        with pytest.raises(ValueError, match="online_mode"):
            _cfg(tmp_path, tmp_path / "c", num_epochs=2)

    def test_tiering_refused_with_online_mode(self, tmp_path):
        with pytest.raises(ValueError, match="online_mode"):
            _cfg(tmp_path, tmp_path / "c", embedding_update="sparse",
                 embedding_tiering="hot_cold", embedding_hot_rows=16)

    def test_publishing_needs_a_directory(self, tmp_path):
        data = tmp_path / "data"
        _make_shards(data, 1)
        with pytest.raises(ValueError, match="publish_dir"):
            tasks.run(_cfg(data, ""), device="cpu")

    def test_online_mode_may_start_before_the_first_shard(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        res = tasks.run(_cfg(data, tmp_path / "ckpt",
                             stream_idle_timeout_secs=0.3), device="cpu")
        assert res["steps"] == 0
