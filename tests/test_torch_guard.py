"""The port's numerical guard and stall watchdog
(``deepfm_tpu_torch.train.guard``) and the fit loop's skip/rollback
policies, on the CPU, mirroring ``tests/test_guard.py``.

The guard's verdicts are held against the JAX ``NonFiniteGuard`` on the
same loss streams. A skipped dispatch restores the state snapshot taken
before it (params, optimizer and model state, the counts and the dropout
generator), so a guarded run over a poisoned stream is bit-identical to a
clean run without the poisoned batch, with dropout on. The watchdog tests
use an injected clock and abort (no real timeouts).
"""

import threading
import time

import numpy as np
import pytest
import torch

from deepfm_tpu.train import guard as jax_guard
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.train import guard as guard_lib
from deepfm_tpu_torch.train.state import StateSnapshot
from deepfm_tpu_torch.utils import preempt as preempt_lib

torch.set_num_threads(1)

NAN = float("nan")


class _DataHealth:
    def summary(self):
        return "read_retries=0 bad_records=0"


# ---------------------------------------------------------------------------
# TrainHealth
# ---------------------------------------------------------------------------

def test_train_health_counters_and_snapshot():
    th = guard_lib.TrainHealth()
    th.record_preemption()
    th.record_nonfinite_skip()
    th.record_nonfinite_skip()
    th.record_rollback()
    th.record_watchdog_abort()
    th.record_loss_spike()
    th.record_resume_meta_corrupt()
    assert th.snapshot() == {"preemptions": 1, "nonfinite_skips": 2,
                             "rollbacks": 1, "watchdog_aborts": 1,
                             "loss_spikes": 1, "resume_meta_corrupt": 1}
    assert guard_lib.TrainHealth.COUNTERS == jax_guard.TrainHealth.COUNTERS


def test_train_health_summary_and_dirty():
    th = guard_lib.TrainHealth()
    assert th.consume_dirty() is False
    th.record_rollback()
    assert "rollbacks=1" in th.summary() and "preemptions=0" in th.summary()
    assert th.consume_dirty() is True
    assert th.consume_dirty() is False


def test_train_health_thread_safety():
    th = guard_lib.TrainHealth()
    threads = [threading.Thread(
        target=lambda: [th.record_nonfinite_skip() for _ in range(500)])
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert th.nonfinite_skips == 2000


# ---------------------------------------------------------------------------
# NonFiniteGuard against the JAX guard
# ---------------------------------------------------------------------------

def _verdicts(mod, policy, max_events, stream, **kw):
    g = mod.NonFiniteGuard(policy=policy, max_events=max_events, **kw)
    out = []
    for step, (loss, bad) in enumerate(stream, 1):
        try:
            out.append(g.observe(loss, step, params_bad=bad))
        except mod.NonFiniteError as e:
            out.append(("raise", str(e)))
            break
    return out, g.health.snapshot(), g.events


def _stream(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        loss = (NAN if r < 0.06 else float("inf") if r < 0.09
                else -float("inf") if r < 0.1
                else float(0.7 + 0.05 * rng.standard_normal()))
        if r > 0.995:
            loss = 40.0  # a finite spike
        out.append((loss, bool(rng.random() < 0.04)))
    return out


@pytest.mark.parametrize("policy", ["abort", "skip", "rollback"])
@pytest.mark.parametrize("max_events", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verdict_sequences_match_jax_guard(policy, max_events, seed):
    """The same loss/param streams through both guards: the same verdicts
    in the same order, the same error text where one raises, the same
    health counters (the spike detector on) and budget use."""
    stream = _stream(seed)
    kw = dict(spike_zscore=3.0, spike_warmup=5)
    got = _verdicts(guard_lib, policy, max_events, stream, **kw)
    want = _verdicts(jax_guard, policy, max_events, stream, **kw)
    assert got == want


def test_guard_units():
    with pytest.raises(ValueError, match="abort"):
        guard_lib.NonFiniteGuard(policy="explode")
    g = guard_lib.NonFiniteGuard(policy="skip")
    assert g.observe(0.5, 1) == "ok" and g.events == 0 and g.per_dispatch
    a = guard_lib.NonFiniteGuard(policy="abort")
    assert a.per_dispatch is False
    with pytest.raises(guard_lib.NonFiniteError, match="step 7"):
        a.observe(NAN, 7)
    with pytest.raises(guard_lib.NonFiniteError,
                       match="non-finite parameters"):
        a.observe(0.3, 9, params_bad=True)
    cfg = Config(data_dir="/tmp/x", on_nonfinite="rollback", max_rollbacks=7,
                 loss_spike_zscore=4.0)
    r = guard_lib.NonFiniteGuard.from_config(cfg)
    assert r.policy == "rollback" and r.max_events == 7
    assert r.spike_zscore == 4.0


def test_params_nonfinite_detects_and_skips_int_leaves():
    ok = {"w": torch.ones(4), "ids": torch.arange(4, dtype=torch.int32)}
    assert guard_lib.NonFiniteGuard.params_nonfinite(ok) is False
    bad = {"w": torch.tensor([1.0, NAN])}
    assert guard_lib.NonFiniteGuard.params_nonfinite(bad) is True
    ints = {"ids": torch.arange(4, dtype=torch.int32)}
    assert guard_lib.NonFiniteGuard.params_nonfinite(ints) is False


# ---------------------------------------------------------------------------
# The state snapshot
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(feature_size=50, field_size=4, embedding_size=4,
                deep_layers="8", dropout="0.5", batch_size=8,
                compute_dtype="float32", learning_rate=0.05, log_steps=0,
                seed=13, scale_lr_by_world=False, mesh_data=1, mesh_model=1,
                steps_per_loop=1)
    base.update(kw)
    return Config(**base)


def _batches(n, bs=8, fields=4, nan_at=()):
    rng = np.random.default_rng(42)
    out = []
    for i in range(n):
        b = {"feat_ids": rng.integers(0, 50, (bs, fields)).astype(np.int32),
             "feat_vals": rng.normal(size=(bs, fields)).astype(np.float32),
             "label": (rng.random((bs, 1)) < 0.3).astype(np.float32)}
        if i in nan_at:
            b["feat_vals"] = np.full((bs, fields), NAN, np.float32)
        out.append(b)
    return out


def _tensors(state):
    out = {f"p.{k}": v.detach().clone() for k, v in state.params.items()}
    opt = state.opt_state
    if "embed" in opt:
        for name, tabs in opt["embed"].items():
            for key, e in tabs.items():
                for f in e._fields:
                    out[f"e.{name}.{key}.{f}"] = getattr(e, f).clone()
        opt = opt["base"]
    for slot in ("mu", "nu"):
        for k, v in opt.get(slot, {}).items():
            out[f"{slot}.{k}"] = v.clone()
    out["rng"] = state.rng.get_state()
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


LAYOUTS = {
    "dense": {},
    "fused": {"embedding_update": "sparse"},
    "hashed": {"embedding_update": "sparse", "embedding_buckets": "31,17"},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_snapshot_restore_undoes_a_step(layout):
    """take, one training step, restore: every tensor, the counts and the
    generator are back, and the next step equals the step it undid."""
    tr = Trainer(_cfg(**LAYOUTS[layout]), device="cpu")
    st = tr.init_state()
    b0, b1 = (tr.put_batch(b) for b in _batches(2))
    st, _ = tr.train_step(st, b0)
    snap = StateSnapshot()
    snap.take(st)
    assert snap.nbytes == sum(
        t.numel() * t.element_size() for t in StateSnapshot._split(st)[0])
    before = _tensors(st)
    step, count = st.step, st.opt_state["count"]
    st, m1 = tr.train_step(st, b1)
    after = _tensors(st)
    st = snap.restore(st)
    _assert_same(_tensors(st), before)
    assert st.step == step and st.opt_state["count"] == count
    st, m2 = tr.train_step(st, b1)
    _assert_same(_tensors(st), after)
    assert torch.equal(m1["loss"], m2["loss"])


# ---------------------------------------------------------------------------
# The fit loop's policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_skip_is_bit_identical_to_clean_run_without_poison(layout):
    """A guarded run over [b0, b1, NaN, b2, b3] equals a clean run over
    [b0, b1, b2, b3] bit for bit, dropout on: the poisoned dispatch is
    consumed, its update and its generator draws are not."""
    clean = _batches(4)
    poisoned = clean[:2] + _batches(1, nan_at=(0,)) + clean[2:]
    cfg = _cfg(on_nonfinite="skip", **LAYOUTS[layout])
    tr_clean = Trainer(cfg, device="cpu")
    s_clean, o_clean = tr_clean.fit(tr_clean.init_state(), clean)
    th = guard_lib.TrainHealth()
    guard = guard_lib.NonFiniteGuard.from_config(cfg, health=th)
    tr = Trainer(cfg, device="cpu")
    hooked = []
    s_guard, o_guard = tr.fit(tr.init_state(), poisoned, guard=guard,
                              hooks=[lambda s, m: hooked.append(s.step)])
    assert o_guard["steps"] == o_clean["steps"] == 4
    assert s_guard.step == s_clean.step == 4 and hooked == [1, 2, 3, 4]
    assert th.nonfinite_skips == 1
    _assert_same(_tensors(s_clean), _tensors(s_guard))
    assert o_guard["loss"] == o_clean["loss"]


def test_skip_under_tiering_keeps_installs_and_matches_clean_run():
    """Under the hot/cold tier the snapshot is taken after the dispatch's
    cache transaction: a skipped dispatch keeps its installs, and the
    densified tables still equal the clean run's."""
    tier = dict(embedding_update="sparse", embedding_tiering="hot_cold",
                embedding_hot_rows=40, feature_size=50)
    clean = _batches(5)
    poisoned = clean[:2] + _batches(1, nan_at=(0,)) + clean[2:]
    cfg = _cfg(on_nonfinite="skip", **tier)
    tr_clean = Trainer(cfg, device="cpu")
    s_clean, _ = tr_clean.fit(tr_clean.init_state(), clean)
    tr = Trainer(cfg, device="cpu")
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    s_guard, out = tr.fit(tr.init_state(), poisoned, guard=guard)
    assert out["steps"] == 5 and guard.health.nonfinite_skips == 1
    a = tr_clean._tier.checkpoint_state(s_clean)
    b = tr._tier.checkpoint_state(s_guard)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name


def test_skip_reports_finite_final_loss():
    cfg = _cfg(on_nonfinite="skip")
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    tr = Trainer(cfg, device="cpu")
    _, summary = tr.fit(tr.init_state(), _batches(4, nan_at=(3,)),
                        guard=guard)
    assert summary["steps"] == 3 and np.isfinite(summary["loss"])


def test_abort_raises_on_log_cadence():
    cfg = _cfg(on_nonfinite="abort", log_steps=1)
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(guard_lib.NonFiniteError, match="non-finite"):
        tr.fit(tr.init_state(), _batches(4, nan_at=(1,)), guard=guard)


def test_rollback_raises_signal_with_the_step_after_the_dispatch():
    cfg = _cfg(on_nonfinite="rollback")
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(guard_lib.RollbackSignal) as ei:
        tr.fit(tr.init_state(), _batches(4, nan_at=(2,)), guard=guard)
    assert ei.value.step == 3
    assert tr._ring is None


def test_budget_exhaustion_aborts_mid_fit():
    cfg = _cfg(on_nonfinite="skip", max_rollbacks=1)
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(guard_lib.NonFiniteError, match="budget"):
        tr.fit(tr.init_state(), _batches(6, nan_at=(1, 3)), guard=guard)


@pytest.mark.parametrize("accum", [1, 2])
def test_skip_under_steps_per_loop(accum):
    """A poisoned batch inside a steps_per_loop=2 group drops the whole
    group's update (one dispatch); the clean groups still train."""
    cfg = _cfg(on_nonfinite="skip", steps_per_loop=2,
               grad_accum_steps=accum)
    guard = guard_lib.NonFiniteGuard.from_config(cfg)
    tr = Trainer(cfg, device="cpu")
    state, summary = tr.fit(tr.init_state(), _batches(6, nan_at=(2,)),
                            guard=guard)
    assert summary["steps"] == 4 and state.step == 4
    assert guard.health.nonfinite_skips == 1


# ---------------------------------------------------------------------------
# Stall watchdog
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError("condition never became true")
        time.sleep(0.005)


def test_watchdog_fires_once_with_diagnostic_dump():
    t = [0.0]
    fired = []
    th = guard_lib.TrainHealth()
    wd = guard_lib.StallWatchdog(30.0, health=th, data_health=_DataHealth(),
                                 abort=fired.append, clock=lambda: t[0],
                                 poll_s=0.001)
    with wd:
        wd.beat(17)
        t[0] = 31.0
        _wait_for(lambda: fired)
        time.sleep(0.02)
    assert len(fired) == 1
    dump = fired[0]
    assert "no dispatch completed" in dump and "step 17" in dump
    assert "data health:" in dump and "train health:" in dump
    assert th.watchdog_aborts == 1 and wd.fired is True


def test_watchdog_beats_keep_it_quiet():
    t = [0.0]
    fired = []
    wd = guard_lib.StallWatchdog(10.0, abort=fired.append,
                                 clock=lambda: t[0], poll_s=0.001)
    with wd:
        for i in range(5):
            t[0] += 9.0
            wd.beat(i)
            time.sleep(0.005)
    assert not fired and wd.fired is False


def test_watchdog_default_abort_is_the_watchdog_exit_code(monkeypatch):
    codes = []
    monkeypatch.setattr(guard_lib.os, "_exit", codes.append)
    guard_lib.StallWatchdog._default_abort("dump")
    assert codes == [preempt_lib.EXIT_WATCHDOG] == [43]


def test_trainer_builds_watchdog_only_when_configured():
    assert Trainer(_cfg(), device="cpu")._make_watchdog(None, None) is None
    tr = Trainer(_cfg(dispatch_timeout_s=60.0), device="cpu")

    def aborter(dump):
        pass

    tr.watchdog_abort = aborter
    wd = tr._make_watchdog(None, None)
    try:
        assert wd is not None and wd._abort is aborter
        assert wd.timeout_s == 60.0
    finally:
        wd.stop()


@pytest.mark.parametrize("depth", [0, 2])
def test_fit_stall_aborts_via_injected_hook(depth):
    """A source that stops producing mid-run trips the watchdog, which
    calls the injected abort (not os._exit) once, with its dump."""
    cfg = _cfg(dispatch_timeout_s=0.15, transfer_ahead=depth)
    tr = Trainer(cfg, device="cpu")
    fired = threading.Event()
    dumps = []
    tr.watchdog_abort = lambda d: (dumps.append(d), fired.set())

    def stalling_source():
        yield from _batches(2)
        fired.wait(timeout=10.0)  # stall until the watchdog trips

    state, summary = tr.fit(tr.init_state(), stalling_source())
    assert fired.is_set(), "watchdog never fired on the stalled source"
    assert summary["steps"] == 2 and len(dumps) == 1
    assert "no dispatch completed" in dumps[0] and "step 2" in dumps[0]
