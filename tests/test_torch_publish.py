"""The port's hot publisher (``train.publish.Publisher``), its pointer
history and its crash seam, on the CPU.

The cadence (step boundaries, the time cadence on an injected clock,
``seed_cadence``, cadences skipped while a publish is in flight) and the
``LATEST`` pointer's moves are compared with the JAX package's
``Publisher`` on the same step sequences (tolerance: none). The rest holds
the port's own artifacts: a crash at each of the three stages heals, a
wedged publish trips the injected abort, the marker records the step, and
the snapshot is the state as it was at ``publish_now``, whatever the fit
loop does to the state in place afterwards.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from deepfm_tpu.train.publish import Publisher as JaxPublisher
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.train.publish import Publisher
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import faults as faults_lib

torch.set_num_threads(1)

F = 5


@pytest.fixture(scope="module")
def tiny():
    cfg = Config(feature_size=64, field_size=F, embedding_size=4,
                 deep_layers="8", dropout="1.0", batch_size=16, log_steps=0,
                 seed=11)
    trainer = Trainer(cfg, device="cpu")
    return cfg, trainer, trainer.init_state()


# What the cadence tests hand both publishers: a state whose tensors the
# JAX side's device_get reads as arrays too.
STUB_STATE = types.SimpleNamespace(params={"w": torch.zeros(2)},
                                   model_state={})


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(tiny, tmp_path, **kw):
    """The port's and the JAX package's publisher, each with its artifact
    write replaced by a record of the steps it ran."""
    cfg = tiny[0]
    kw.setdefault("every_steps", 4)
    clocks = (kw.pop("clock", None), kw.pop("jax_clock", None))
    pubs = []
    for i, make in enumerate((lambda d, **k: Publisher(cfg, d, **k),
                              lambda d, **k: JaxPublisher(None, None, d, **k))):
        extra = {"clock": clocks[i]} if clocks[i] is not None else {}
        pub = make(str(tmp_path / f"p{i}"), **kw, **extra)
        done = []
        pub._do_publish = (lambda p, m, s, done=done:
                           done.append(s) or "ok")
        pubs.append((pub, done))
    return pubs


def _stats(pub):
    st = pub.stats()
    return {k: st[k] for k in ("published_versions", "publish_count",
                               "publish_failures", "publish_skipped_inflight",
                               "publish_staleness_steps_max")}


@pytest.mark.parametrize("every,seed,steps", [
    (4, 0, list(range(1, 13))),
    (4, 5, list(range(6, 10))),
    (3, 0, [4, 8, 12, 16, 17, 25]),  # steps_per_loop-sized jumps
    (8, 7, [9, 16, 24, 31, 33, 64]),
])
def test_step_cadence_equals_jax(tiny, tmp_path, every, seed, steps):
    state = STUB_STATE
    results = []
    for pub, done in _pair(tiny, tmp_path, every_steps=every):
        if seed:
            pub.seed_cadence(seed)
        started = [pub.maybe_publish(state, s) or pub.drain() and False
                   for s in steps]
        pub.close()
        results.append((done, started, _stats(pub)))
    assert results[0] == results[1]
    assert results[0][0]


def test_time_cadence_equals_jax(tiny, tmp_path):
    state = STUB_STATE
    clocks = [FakeClock(), FakeClock()]
    results = []
    for (pub, done), clock in zip(
            _pair(tiny, tmp_path, every_steps=0, every_secs=10.0,
                  clock=clocks[0], jax_clock=clocks[1]), clocks):
        for t, step in ((0.0, 1), (11.0, 2), (15.0, 3), (22.0, 4),
                        (31.9, 5), (32.0, 6)):
            clock.t = t
            pub.maybe_publish(state, step)
            pub.drain()
        pub.close()
        results.append((done, _stats(pub)))
    assert results[0] == results[1]
    assert results[0][0] == [2, 4, 6]


def test_busy_cadence_skipped_not_queued_as_jax(tiny, tmp_path):
    state = STUB_STATE
    results = []
    for pub, _ in _pair(tiny, tmp_path, every_steps=4):
        gate, started = threading.Event(), threading.Event()
        pub._do_publish = (
            lambda p, m, s, gate=gate, started=started:
            (started.set(), gate.wait(30), "ok")[-1])
        trace = [pub.maybe_publish(state, 4)]
        assert started.wait(30)
        trace += [pub.maybe_publish(state, 8), pub.maybe_publish(state, 10)]
        gate.set()
        pub.drain()
        trace.append(pub.maybe_publish(state, 12))
        pub.close()
        results.append((trace, _stats(pub)))
    assert results[0] == results[1]
    assert results[0][0] == [True, False, False, True]
    assert results[0][1]["publish_skipped_inflight"] == 1


def test_pointer_moves_and_history_equal_jax(tiny, tmp_path):
    """LATEST only moves forward, and every move is in the history first:
    the same sequence of versions gives the same pointer and the same
    (version, actor, reason) history on both sides."""
    out = []
    for i, (pub, _) in enumerate(_pair(tiny, tmp_path)):
        pdir = str(tmp_path / f"p{i}")
        seen = []
        for v in ("3", "7", "5", "7", "12", "9"):
            os.makedirs(os.path.join(pdir, v), exist_ok=True)
            pub._advance_latest(v)
            seen.append(os.path.basename(export_lib.read_latest(pdir)))
        hist = [(e["version"], e["actor"], e["reason"])
                for e in export_lib.pointer_history(pdir)]
        out.append((seen, hist))
        pub.close()
    assert out[0] == out[1]
    assert out[0][0] == ["3", "7", "7", "7", "12", "12"]
    assert [h[0] for h in out[0][1]] == ["3", "7", "12"]


def test_pointer_history_append_dedups_and_drops_torn_tail(tmp_path):
    d = str(tmp_path)
    export_lib.append_pointer_event(d, "1", "publish")
    export_lib.append_pointer_event(d, "1", "publish")  # a healing replay
    with open(os.path.join(d, export_lib.POINTER_HISTORY_FILE), "a") as f:
        f.write('{"version": "2", "act')
    assert [e["version"] for e in export_lib.pointer_history(d)] == ["1"]


def _publisher(tiny, tmp_path, **kw):
    kw.setdefault("every_steps", 4)
    return Publisher(tiny[0], str(tmp_path), **kw)


def _load(path):
    return export_lib.load_serving(path, device="cpu")


def test_publish_roundtrip_and_marker_step(tiny, tmp_path):
    state = tiny[2]
    pub = _publisher(tiny, tmp_path)
    pub.publish_now(state, 6)
    pub.close()
    artifact = export_lib.read_latest(str(tmp_path))
    assert os.path.basename(artifact) == "6"
    probs = _load(artifact)(np.zeros((3, F), np.int32),
                            np.ones((3, F), np.float32))
    assert probs.shape == (3,) and np.all(np.isfinite(probs))
    with open(os.path.join(artifact, export_lib.COMPLETE_MARKER)) as f:
        assert json.load(f)["step"] == 6
    assert pub.stats()["published_versions"] == [6]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".")]


def test_crash_before_rename_keeps_previous_artifact(tiny, tmp_path):
    state = tiny[2]
    pub = _publisher(tiny, tmp_path)
    pub.publish_now(state, 1)
    assert pub.drain()
    faults_lib.set_publish_crash("before_rename")
    pub.publish_now(state, 2)
    assert pub.drain()
    assert not os.path.isdir(tmp_path / "2")
    assert os.path.basename(export_lib.read_latest(str(tmp_path))) == "1"
    assert pub.publish_failures == 1
    pub.publish_now(state, 3)  # the next cadence heals
    pub.close()
    assert os.path.basename(export_lib.read_latest(str(tmp_path))) == "3"
    assert pub.stats()["published_versions"] == [1, 3]


@pytest.mark.parametrize("stage", ["after_rename_before_latest",
                                   "after_history_before_latest"])
def test_crash_before_the_pointer_heals_on_retry(tiny, tmp_path, stage):
    state = tiny[2]
    pub = _publisher(tiny, tmp_path)
    pub.publish_now(state, 1)
    assert pub.drain()
    faults_lib.set_publish_crash(stage)
    pub.publish_now(state, 4)
    assert pub.drain()
    # The artifact is complete and visible; only the pointer is stale.
    assert _load(str(tmp_path / "4")) is not None
    assert os.path.basename(export_lib.read_latest(str(tmp_path))) == "1"
    assert pub.publish_failures == 1
    pub.publish_now(state, 4)  # idempotent republish moves the pointer
    pub.close()
    assert os.path.basename(export_lib.read_latest(str(tmp_path))) == "4"
    assert [e["version"] for e in pub.history()] == ["1", "4"]


def test_wedged_publish_trips_abort(tiny, tmp_path):
    state = tiny[2]
    clock = FakeClock()
    aborts = []
    pub = _publisher(tiny, tmp_path, timeout_s=5.0, clock=clock,
                     abort=aborts.append)
    gate = threading.Event()
    pub._do_publish = lambda p, m, s: gate.wait(30)
    pub.publish_now(state, 4)
    clock.t = 4.0
    pub.check_wedged()
    assert not aborts
    clock.t = 6.0
    pub.check_wedged()
    assert len(aborts) == 1 and "publish of step 4" in aborts[0]
    gate.set()
    pub.close()


def test_snapshot_is_taken_before_a_later_in_place_step(tiny, tmp_path):
    """The export runs later on the executor thread, while the fit loop
    updates the state's tensors in place: it must see the host copy taken
    at publish_now, never the live tensors."""
    cfg, trainer, _ = tiny
    state = trainer.init_state(seed=5)
    want = {k: v.detach().clone() for k, v in state.params.items()}
    pub = _publisher(tiny, tmp_path)
    gate = threading.Event()
    pub._executor.submit(gate.wait, 30)  # hold the executor
    pub.publish_now(state, 8)
    with torch.no_grad():
        for v in state.params.values():
            v.add_(1.0)  # the next dispatch's in-place update
    gate.set()
    pub.close()
    saved = torch.load(str(tmp_path / "8" / "params.pt"), weights_only=True)
    for k, v in want.items():
        assert torch.equal(saved[k], v), k
