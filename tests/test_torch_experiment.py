"""The port's experiment router (``deepfm_tpu_torch.serve.experiment``) and
promotion controller (``deepfm_tpu_torch.train.promote``) against the JAX
package's, on the CPU.

Everything here is host logic, so the tolerance is none:
``_mix64``/``assign_arm`` over 10^5 ids and several seeds, ``evaluate_gates``
over a table of challenger and control windows (NaN, a missing key, each
breach), the ``PromotionController`` driven by one sequence of observations
in both packages (equal decisions, ``pointer_history()``, ``LATEST`` and
stats, a publish crash at ``after_history_before_latest`` included), and
the router's modes, shadow isolation and kill-switch over stub engines.
"""

import os
import time
import types

import numpy as np
import pytest
import torch

from deepfm_tpu.serve import experiment as jax_exp
from deepfm_tpu.serve.engine import ServeFuture as JaxServeFuture
from deepfm_tpu.train import promote as jax_promote
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu.utils import faults as jax_faults
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.serve import experiment
from deepfm_tpu_torch.serve.engine import ServeFuture
from deepfm_tpu_torch.train import promote
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import faults

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(exp=jax_exp, promote=jax_promote,
                                 export=jax_export, faults=jax_faults,
                                 future=JaxServeFuture),
    "port": types.SimpleNamespace(exp=experiment, promote=promote,
                                  export=export_lib, faults=faults,
                                  future=ServeFuture),
}


@pytest.mark.parametrize("seed", [0, 7, 9, 2026, (1 << 63) + 5])
def test_mix64_and_assign_arm_equal(seed):
    ids = np.arange(100_000, dtype=np.int64)
    ids[::7] = ids[::7] * 1_000_003 + (1 << 40)      # large ids too
    for rid in ids[:2000].tolist():
        assert experiment._mix64(seed, rid) == jax_exp._mix64(seed, rid)
    for permille in (0, 5, 50, 600, 999, 1000):
        got = [experiment.assign_arm(r, seed=seed,
                                     challenger_permille=permille)
               for r in ids.tolist()]
        want = [jax_exp.assign_arm(r, seed=seed,
                                   challenger_permille=permille)
                for r in ids.tolist()]
        assert got == want
    assert (experiment.ARM_CONTROL, experiment.ARM_CHALLENGER,
            experiment.MODES) == (jax_exp.ARM_CONTROL, jax_exp.ARM_CHALLENGER,
                                  jax_exp.MODES)


HEALTHY = dict(n=100, auc=0.74, p99_latency_ms=8.0, nonfinite=0,
               calibration_err=0.05)
CONTROL = dict(n=100, auc=0.75, p99_latency_ms=7.0, nonfinite=0,
               calibration_err=0.04)
GATE_CASES = {
    "healthy": (HEALTHY, CONTROL, 0.0),
    "nonfinite": (dict(HEALTHY, nonfinite=2), CONTROL, 0.0),
    "nonfinite_thin": (dict(HEALTHY, nonfinite=1, n=3), CONTROL, 0.0),
    "auc": (dict(HEALTHY, auc=0.60), CONTROL, 0.0),
    "latency_ratio": (dict(HEALTHY, p99_latency_ms=20.0), CONTROL, 0.0),
    "latency_ceiling": (dict(HEALTHY, p99_latency_ms=90.0),
                        dict(CONTROL, p99_latency_ms=80.0), 0.0),
    "calibration": (dict(HEALTHY, calibration_err=0.5), CONTROL, 0.0),
    "stale": (HEALTHY, CONTROL, 500.0),
    "thin": (dict(HEALTHY, n=3), CONTROL, 0.0),
    "nan_auc": (dict(HEALTHY, auc=float("nan")), CONTROL, 0.0),
    "none_auc": (dict(HEALTHY, auc=None), dict(CONTROL, auc=None), 0.0),
    "missing_keys": ({"n": 100}, {}, 0.0),
    "empty": ({}, {}, 0.0),
    "zero_control_p99": (HEALTHY, dict(CONTROL, p99_latency_ms=0.0), 0.0),
    "nan_p99": (dict(HEALTHY, p99_latency_ms=float("nan")), CONTROL, 0.0),
    "inf_calibration": (dict(HEALTHY, calibration_err=float("inf")),
                        CONTROL, 0.0),
    "every_breach": (dict(HEALTHY, nonfinite=1, auc=0.1,
                          p99_latency_ms=200.0, calibration_err=0.9),
                     CONTROL, 1000.0),
}
GATES = dict(min_samples=50, min_auc_delta=-0.02, max_p99_ratio=1.5,
             max_p99_ms=60.0, max_nonfinite=0, max_calibration_err=0.2,
             max_candidate_age_s=300.0, windows_required=2)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_evaluate_gates_equal(case):
    ch, ctl, age = GATE_CASES[case]
    got = promote.evaluate_gates(ch, ctl, promote.GateConfig(**GATES),
                                 candidate_age_s=age)
    want = jax_promote.evaluate_gates(ch, ctl, jax_promote.GateConfig(**GATES),
                                      candidate_age_s=age)
    assert got == want


def test_gate_vocabulary_and_validation_equal():
    for name in ("REASON_NONFINITE", "REASON_AUC", "REASON_LATENCY",
                 "REASON_CALIBRATION", "REASON_STALE", "REASON_QUARANTINED",
                 "REASON_SAMPLES", "BREACH_REASONS", "QUARANTINE_FAILURES"):
        assert getattr(promote, name) == getattr(jax_promote, name)
    for bad in (dict(min_samples=0), dict(max_p99_ratio=0),
                dict(max_p99_ms=-1), dict(max_nonfinite=-1),
                dict(max_calibration_err=-1), dict(max_candidate_age_s=-1),
                dict(windows_required=0)):
        with pytest.raises(ValueError):
            promote.GateConfig(**bad)
        with pytest.raises(ValueError):
            jax_promote.GateConfig(**bad)


def test_gate_config_from_config():
    cfg = Config(experiment_min_samples=9, experiment_min_auc_delta=-0.1,
                 experiment_max_p99_ratio=2.0, experiment_max_p99_ms=40.0,
                 experiment_max_nonfinite=1,
                 experiment_max_calibration_err=0.3,
                 experiment_max_candidate_age_s=60.0,
                 experiment_gate_windows=3)
    assert promote.GateConfig.from_config(cfg) == promote.GateConfig(
        min_samples=9, min_auc_delta=-0.1, max_p99_ratio=2.0,
        max_p99_ms=40.0, max_nonfinite=1, max_calibration_err=0.3,
        max_candidate_age_s=60.0, windows_required=3)


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        return self.t


# (action, version/health) steps driven through both controllers.
SEQUENCE = [
    ("offer", "2"), ("observe", (HEALTHY, CONTROL)),
    ("observe", (dict(HEALTHY, n=3), CONTROL)),            # hold
    ("observe", (HEALTHY, CONTROL)),                       # promote
    ("offer", "2"),                                        # already stable
    ("offer", "3"), ("observe", (dict(HEALTHY, nonfinite=4), CONTROL)),
    ("offer", "3"), ("observe", (dict(HEALTHY, auc=0.2), CONTROL)),
    ("offer", "3"),                                        # quarantined
    ("offer", "4"), ("tick", 400.0), ("observe", (HEALTHY, CONTROL)),
    ("crash", "after_history_before_latest"),
    ("offer", "5"), ("observe", (HEALTHY, CONTROL)),
    ("observe", (HEALTHY, CONTROL)),                       # promote: crash
    ("offer", "5"), ("observe", (HEALTHY, CONTROL)),
    ("observe", (HEALTHY, CONTROL)),                       # heals
    ("observe", (HEALTHY, CONTROL)),                       # no candidate
]


def _drive_controller(pkg, root):
    d = os.path.join(root, "publish")
    for version in ("1", "2", "3", "4", "5"):
        os.makedirs(os.path.join(d, version))
    pkg.export.write_latest(d, "1")
    clock = _Clock()
    wall = iter(range(1000, 2000))
    kills = []
    ctl = pkg.promote.PromotionController(
        d, gates=pkg.promote.GateConfig(**GATES),
        on_rollback=lambda v, r: kills.append((v, r)), clock=clock,
        wall_time=lambda: float(next(wall)))
    log = []
    try:
        for action, arg in SEQUENCE:
            if action == "offer":
                log.append(("offer", ctl.offer(arg)))
            elif action == "tick":
                clock.t += arg
            elif action == "crash":
                pkg.faults.set_publish_crash(arg)
            else:
                try:
                    dcs = ctl.observe(*arg)
                    log.append(("decision", dcs.action, dcs.version,
                                dcs.reasons))
                except pkg.faults.InjectedFault as e:
                    log.append(("crash", str(e)))
                log.append(("latest",
                            os.path.basename(pkg.export.read_latest(d))))
    finally:
        pkg.faults.set_publish_crash("")
    hist = [{k: v for k, v in e.items()} for e in ctl.history()]
    return log, hist, ctl.stats(), kills, \
        os.path.basename(pkg.export.read_latest(d))


def test_promotion_controller_sequence_equal(tmp_path):
    jax_out = _drive_controller(PKGS["jax"], str(tmp_path / "jax"))
    port_out = _drive_controller(PKGS["port"], str(tmp_path / "port"))
    assert port_out == jax_out
    log, hist, stats, kills, latest = port_out
    assert ("crash", "injected publish crash at stage "
            "'after_history_before_latest'") in log
    assert stats["promotions"] == 2 and stats["quarantines"] == 1
    assert stats["quarantined_versions"] == ["3"]
    assert latest == "5"
    assert [e["actor"] for e in hist].count("promote") == 2


def test_controller_needs_a_pointer(tmp_path):
    with pytest.raises(ValueError, match="no stable_version"):
        promote.PromotionController(str(tmp_path),
                                    gates=promote.GateConfig())


# -- the router over stub engines ------------------------------------------


class StubEngine:
    def __init__(self, future_cls, fn, *, delay_s=0.0, raise_on_submit=None,
                 error_on_resolve=None):
        self.future_cls = future_cls
        self.fn = fn
        self.delay_s = delay_s
        self.raise_on_submit = raise_on_submit
        self.error_on_resolve = error_on_resolve
        self.submits = 0

    def submit(self, ids, vals, trace_id=None, value="default"):
        if self.raise_on_submit is not None:
            raise self.raise_on_submit
        self.submits += 1
        fut = self.future_cls(np.asarray(ids), np.asarray(vals),
                              time.monotonic(), trace_id=trace_id,
                              value=value)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.error_on_resolve is not None:
            fut.set_error(self.error_on_resolve)
        else:
            fut.set_result(self.fn(np.asarray(ids), np.asarray(vals)), 0.1)
        return fut


def _ctl_fn(ids, vals):
    return (ids[:, 0] % 7).astype(np.float32) / 10.0


def _nan_fn(ids, vals):
    return np.full(ids.shape[0], np.nan, np.float32)


def _stream(n=60, rows=3, field=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 64, (rows, field)).astype(np.int32),
             rng.normal(size=(rows, field)).astype(np.float32))
            for rid in range(n)]


ROUTER_CASES = {
    "shadow_raising": dict(mode="shadow", challenger=dict(
        raise_on_submit=RuntimeError("dead arm"))),
    "shadow_nan": dict(mode="shadow", challenger=dict(fn=_nan_fn)),
    "shadow_error": dict(mode="shadow", challenger=dict(
        error_on_resolve=RuntimeError("boom"))),
    "shadow_slow": dict(mode="shadow", challenger=dict(delay_s=0.004),
                        shadow_slo_ms=1.0),
    "canary": dict(mode="canary", kill_at=30),
    "ab": dict(mode="ab"),
    "off": dict(mode="off"),
    "shadow_killed": dict(mode="shadow", kill_at=20, revive_at=40),
}


def _drive_router(pkg, case):
    spec = ROUTER_CASES[case]
    ch_kw = dict(spec.get("challenger", {}))
    ch_fn = ch_kw.pop("fn", lambda i, v: _ctl_fn(i, v) + 0.5)
    control = StubEngine(pkg.future, _ctl_fn)
    challenger = StubEngine(pkg.future, ch_fn, **ch_kw)
    seen = []
    r = pkg.exp.ExperimentRouter(
        control, challenger, mode=spec["mode"], seed=3,
        challenger_permille=400,
        shadow_slo_ms=spec.get("shadow_slo_ms", 0.0),
        on_shadow_result=lambda rid, p, lat: seen.append(
            (rid, np.asarray(p, np.float32).tobytes())))
    out = []
    for rid, ids, vals in _stream():
        if rid == spec.get("kill_at"):
            r.kill("breach")
        if rid == spec.get("revive_at"):
            r.revive()
        fut = r.submit(ids, vals, rid)
        out.append((getattr(fut, "arm", None), fut.result(1).tolist()))
    summary = {k: v for k, v in r.summary().items()
               if k not in ("shadow_p50_ms", "shadow_p99_ms")}
    r.close()
    return out, summary, seen, control.submits, challenger.submits


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_matches_jax(case):
    """Primary answers and arms, the typed shadow counters, the shadow
    hook's observations and each engine's submit count are the JAX
    router's (the shadow lane's latencies aside)."""
    assert _drive_router(PKGS["port"], case) == _drive_router(PKGS["jax"],
                                                              case)


def test_router_validation_equal():
    for kw in (dict(mode="bogus"), dict(mode="ab"),
               dict(mode="off", challenger_permille=1001)):
        for pkg in PKGS.values():
            with pytest.raises(ValueError):
                pkg.exp.ExperimentRouter(object(), **kw)


def test_router_and_controller_register_their_metrics(tmp_path):
    """``metrics_lib.auto_register``: the router's summary and the
    controller's stats appear in the registry's snapshot."""
    from deepfm_tpu_torch.obs import metrics as metrics_lib
    r = experiment.ExperimentRouter(object(), mode="off",
                                     challenger_permille=77)
    os.makedirs(tmp_path / "1")
    export_lib.write_latest(str(tmp_path), "1")
    ctl = promote.PromotionController(str(tmp_path),
                                      gates=promote.GateConfig())
    snap = metrics_lib.REGISTRY.snapshot()
    assert any(k.startswith("experiment") and k.endswith(
        ".experiment_permille") and v == 77 for k, v in snap.items())
    assert any(k.startswith("promotion") and k.endswith(".stable_version")
               and v == "1" for k, v in snap.items())
    del r, ctl


# -- the experiment drill at seed 7 -----------------------------------------


def test_experiment_drill_decisions_match_jax(tmp_path):
    """``run_experiment_drill(seed=7, params=EXPERIMENT_SMOKE)`` at the JAX
    drill's model: the same decisions (actions and reasons per scenario),
    one promotion, ``stable_version == "1"``, the same pointer history's
    actors and shadow counts, and the offline per-arm health equal to the
    online one. Seed 7 only: the smoke gates were tuned to it (at seed 9
    the JAX drill rolls its healthy challenger back)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import production_drill as jax_drill
    from deepfm_tpu_torch.drills import production

    want = jax_drill.run_experiment_drill(
        str(tmp_path / "jax"), seed=7, params=jax_drill.EXPERIMENT_SMOKE)
    got = production.run_experiment_drill(
        str(tmp_path / "port"), seed=7, params=production.EXPERIMENT_SMOKE,
        device="cpu")
    assert got["ok"] and got["stable_version"] == "1"
    assert got["scenarios"] == want["scenarios"]
    assert got["promotion"] == want["promotion"]
    assert got["promotion"]["promotions"] == 1
    assert got["arm_health_offline_match"] is True
    assert got["chaos"] == want["chaos"]
    assert [(e["version"], e["actor"]) for e in got["pointer_history"]] == \
        [(e["version"], e["actor"]) for e in want["pointer_history"]]
    for k in ("shadow_submitted", "shadow_completed", "shadow_errors",
              "shadow_nonfinite"):
        assert got["shadow_summary"][k] == want["shadow_summary"][k], k
    assert got["primary"]["failed"] == got["primary"]["nonfinite"] == 0
    assert got["primary"]["requests"] == want["primary"]["requests"]
    assert got["nan_batches_poisoned"] == want["nan_batches_poisoned"]


def test_experiment_drill_wide_vocabulary(tmp_path):
    """At ``Config()``'s vocabulary (117,581 ids; K and the tower narrow
    here) the drill's default overrides are ``EXPERIMENT_WIDE``: the
    healthy challenger trains on every plan row, ranks every gate window
    (AUC >= 0.95, 1.0 here) and is promoted; the three poisoned
    challengers are rolled back and quarantined with their reasons."""
    from deepfm_tpu_torch.drills import production

    model = dict(feature_size=Config().feature_size, field_size=39,
                 embedding_size=4, deep_layers="8", dropout="0.5",
                 compute_dtype="float32")
    r = production.run_experiment_drill(str(tmp_path), seed=7, model=model,
                                        device="cpu")
    assert r["params"]["train_steps"] == \
        production.EXPERIMENT_WIDE["train_steps"]
    windows = r["shadow_validation"] + r["canary_windows"]
    assert len(windows) == 2 * r["params"]["windows_required"]
    for w in windows:
        assert w["challenger_n"] > 0 and w["challenger_auc"] >= 0.95, w
    assert [w["action"] for w in r["canary_windows"]] == ["pass", "promote"]
    assert r["stable_version"] == "1" and r["promotion"]["promotions"] == 1
    assert {s["kind"]: [d[0] for d in s["decisions"]]
            for s in r["scenarios"]} == {
        k: ["rollback", "quarantine"] for k in (
            "challenger_nan", "challenger_slow", "challenger_stale")}
    assert r["arm_health_offline_match"] is True
