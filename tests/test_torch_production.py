"""The port's production drills (``deepfm_tpu_torch.drills.production``)
against the JAX repo's ``scripts/production_drill.py`` on the CPU, at the
JAX drill's model (``TINY_MODEL``: its ``FEATURE_SIZE``, ``FIELD_SIZE`` and
widths).

* ``run_smoke`` (serve -> log -> join -> train -> publish in one process,
  the scheduled publish crash live, traced): the same ``audit_fingerprint``
  and ``LoopHealth`` counters as the JAX ``run_smoke`` at the same seed,
  every gate green, and a merged trace whose serve flush overlaps a newer
  version's publish.
* ``run_overload_drill``: the same seed-pure parts as the JAX drill (the
  chaos schedule's and the audit fingerprints), with the ladder engaged
  and recovered.
* ``run_cache_drill``: the fast path on and off give bit-identical arms.
* The full drill (the launcher as a supervised subprocess, SIGTERM and a
  resume) is marked slow, as the JAX package marks its own.
The tolerance is none: every compared value is a function of the seeds.
"""

import json
import os
import sys

import pytest
import torch

from deepfm_tpu_torch.drills import production
from deepfm_tpu_torch.loop import DiurnalTrafficPlan, SeededLabelFeed
from deepfm_tpu_torch.obs import trace as trace_lib
from deepfm_tpu_torch.utils import faults

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "scripts"))
import production_drill as jax_drill  # noqa: E402

torch.set_num_threads(1)


def test_tiny_model_is_the_jax_drills():
    m = production.TINY_MODEL
    assert (m["feature_size"], m["field_size"]) == (jax_drill.FEATURE_SIZE,
                                                   jax_drill.FIELD_SIZE)
    flags = jax_drill._flags("d", "m", 6, 10.0)
    for k, v in m.items():
        assert flags[k] == v, k
    port_flags = production._flags("d", "m", 6, 10.0)
    assert {k: v for k, v in port_flags.items() if k in flags} == flags
    for name in ("FULL", "SMOKE", "OVERLOAD", "EXPERIMENT",
                 "EXPERIMENT_SMOKE", "CACHE_DRILL", "BATCH_SIZE",
                 "SHARD_RECORDS", "MIN_HOT_SWAPS", "SHADOW_IID_OFFSET"):
        assert getattr(production, name) == getattr(jax_drill, name), name


@pytest.mark.parametrize("seed", [7, 11, 2026])
def test_expected_join_and_audit_fingerprint_equal(seed):
    """The seed-pure core of the audit: the simulated join and the
    fingerprint over the schedule, the plan and the labels."""
    kw = dict(duration_s=8.0, base_qps=5.0, peak_qps=9.0, feature_size=32,
              field_size=4, max_rows=3)
    out = []
    for mod, plan_cls, feed_cls, faults_mod in (
            (jax_drill, jax_drill.DiurnalTrafficPlan,
             jax_drill.SeededLabelFeed, jax_drill.faults_lib),
            (production, DiurnalTrafficPlan, SeededLabelFeed, faults)):
        sched = faults_mod.ChaosSchedule.generate(seed, horizon_s=8.0,
                                                  publish_crashes=1)
        plan = plan_cls(seed, **kw)
        feed = feed_cls(seed + 1, delay_min_s=0.3, delay_max_s=4.5)
        counters, labels = mod._expected_join(plan, feed, 3.0)
        out.append((counters, labels,
                    mod._audit_fingerprint(sched, plan, counters, labels)))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def jax_smoke(tmp_path_factory):
    return jax_drill.run_smoke(str(tmp_path_factory.mktemp("jax_smoke")),
                               verbose=False)


def test_smoke_matches_jax(tmp_path, jax_smoke):
    r = production.run_smoke(str(tmp_path / "port"), device="cpu",
                             trace="ring")
    assert r["ok"] and r["mode"] == "smoke"
    assert r["determinism"]["audit_fingerprint"] == \
        jax_smoke["determinism"]["audit_fingerprint"]
    assert r["loop_health"] == jax_smoke["loop_health"]
    assert r["chaos"]["fingerprint"] == jax_smoke["chaos"]["fingerprint"]
    assert r["traffic"] == jax_smoke["traffic"]
    # The gates, as the JAX test holds them.
    assert r["request_loss"] == dict(r["request_loss"], failed=0,
                                     overloads=0, swap_failures=0,
                                     watcher_errors=0)
    assert r["request_loss"]["hot_swaps"] >= production.MIN_HOT_SWAPS
    assert r["determinism"]["counters_match_simulation"]
    assert r["determinism"]["labels_match_simulation"]
    assert r["skew"] == {"records_audited": r["traffic"]["rows"],
                         "mismatches": 0}
    assert r["chaos"]["publish_crash_fired"]
    assert r["publish"]["crashed_version"] not in r["publish"]["versions"]
    assert r["publish"]["staging_leaks"] >= 1
    assert r["publish"]["final_params_finite"]
    assert max(r["publish"]["versions"]) >= 3 * 4
    assert r["publish"]["trainer"]["publish_failures"] == 1
    assert r["staleness"]["covered_rows"] > 0
    # The merged trace: a request served by version N while version M > N
    # staged, with request trace ids on the flush.
    corr = r["trace"]["correlated_serve_publish_overlap"]
    assert corr["publish_version"] > corr["serve_model_step"]
    assert corr["sample_trace_ids"]
    with open(r["trace"]["merged_path"]) as f:
        assert len(json.load(f)["traceEvents"]) == r["trace"]["events"] > 0
    assert not trace_lib.enabled()
    assert trace_lib.ENV_MODE not in os.environ


@pytest.fixture(scope="module")
def cascade_publish(tmp_path_factory):
    return production.build_cascade_artifact(
        str(tmp_path_factory.mktemp("cascade") / "publish"), device="cpu")


def test_overload_drill_matches_jax(tmp_path, cascade_publish):
    jpub = jax_drill.build_cascade_artifact(str(tmp_path / "jax_publish"))
    want = jax_drill.run_overload_drill(str(tmp_path / "jax"), seed=7,
                                        publish_dir=jpub)
    got = production.run_overload_drill(str(tmp_path / "port"), seed=7,
                                        publish_dir=cascade_publish,
                                        device="cpu")
    assert got["chaos"] == want["chaos"]
    assert got["audit_fingerprint"] == want["audit_fingerprint"]
    assert got["traffic"] == want["traffic"]
    assert got["params"] == want["params"]
    assert got["ladder_engaged"] and got["recovered"]
    assert got["accounting_ok"] and got["counters"]["failed"] == 0
    assert got["max_rung"] >= 1
    assert sum(got["counters"].values()) == got["traffic"]["requests"]


def test_cache_drill_bit_identical_arms(tmp_path, cascade_publish):
    r = production.run_cache_drill(str(tmp_path), seed=7,
                                   publish_dir=cascade_publish, device="cpu")
    assert r["bit_identical"]
    assert r["on"]["cache_hits"] > 0 and r["off"]["cache_hits"] == 0
    assert r["on"]["repeat_requests"] == r["off"]["repeat_requests"] > 0
    assert r["on"]["requests"] == r["off"]["requests"]


def test_main_smoke_writes_its_report_only_where_asked(tmp_path,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(production, "run_smoke",
                        lambda wd, **kw: calls.append(kw) or {"ok": True})
    monkeypatch.chdir(tmp_path)
    assert production.main(["--smoke", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == []
    report = str(tmp_path / "r.json")
    assert production.main(["--smoke", "--device", "cpu", "--report",
                            report]) == 0
    with open(report) as f:
        assert json.load(f) == {"ok": True}
    assert calls[0]["device"] == "cpu"
    assert calls[0]["model"] == production.TINY_MODEL


@pytest.mark.slow
def test_full_drill_end_to_end(tmp_path):
    """The launcher as a supervised subprocess on the CPU, read faults, a
    publish crash and a SIGTERM with a resume from one schedule."""
    r = production.run_full(str(tmp_path), device="cpu")
    assert r["mode"] == "full"
    assert r["chaos"]["supervised_restarts"] >= 1
    assert r["chaos"]["preemptions_sent_at_logical_s"]
    assert r["chaos"]["publish_crash_fired"]
    assert r["request_loss"]["failed"] == 0
    assert r["request_loss"]["hot_swaps"] >= production.MIN_HOT_SWAPS
    assert r["skew"]["mismatches"] == 0
    assert r["staleness"]["staleness_p95_s"] <= r["staleness"]["bound_s"]
