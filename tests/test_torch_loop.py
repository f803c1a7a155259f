"""The port's closed-loop feedback layer (``deepfm_tpu_torch.loop``) against
the JAX package's ``deepfm_tpu.loop``, on the same seeds and inputs.

Everything here is seed-pure host logic, so the tolerance is none: the
traffic plans' ``fingerprint_data()``, the Zipf population's draws and
histories, the impression bytes, the logger's and the joiner's shard files
and manifests (byte for byte), the joiner's ``LoopHealth`` counters, the
skew checker's verdicts and the float64 metrics must be equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepfm_tpu.data import tfrecord as jax_tfrecord
from deepfm_tpu.loop import health as jax_health
from deepfm_tpu.loop import impressions as jax_imp
from deepfm_tpu.loop import join as jax_join
from deepfm_tpu.loop import metrics as jax_metrics
from deepfm_tpu.loop import skew as jax_skew
from deepfm_tpu.loop import traffic as jax_traffic
from deepfm_tpu_torch.data import tfrecord
from deepfm_tpu_torch.loop import health, impressions, join, metrics, skew
from deepfm_tpu_torch.loop import traffic

torch.set_num_threads(1)

FIELD = 3

PKGS = {
    "jax": dict(tfrecord=jax_tfrecord, health=jax_health, imp=jax_imp,
                join=jax_join, skew=jax_skew),
    "port": dict(tfrecord=tfrecord, health=health, imp=impressions,
                 join=join, skew=skew),
}


def _row(iid):
    ids = (np.arange(FIELD, dtype=np.int32) + iid) % 64
    vals = np.arange(FIELD, dtype=np.float32) * 0.5 + iid
    return ids, vals


def _dir_bytes(d):
    """Every file of ``d`` (dot-file manifests included) -> its bytes."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _imp_shard(pkg, imp_dir, index, iids, served_at=0.0):
    os.makedirs(imp_dir, exist_ok=True)
    path = os.path.join(imp_dir, f"imp-{index:05d}.tfrecords")
    with pkg["tfrecord"].TFRecordWriter(path) as w:
        for iid in iids:
            ids, vals = _row(iid)
            w.write(pkg["imp"].encode_impression(iid, served_at, ids, vals))
    return path


def _pinned(pkg, delay_s, seed=0):
    return pkg["join"].SeededLabelFeed(seed, delay_min_s=delay_s,
                                       delay_max_s=delay_s)


def _joiner(pkg, root, feed, window):
    imp, out = os.path.join(root, "imp"), os.path.join(root, "out")
    os.makedirs(imp, exist_ok=True)
    h = pkg["health"].LoopHealth()
    return imp, out, h, pkg["join"].DelayedLabelJoiner(
        imp, out, feed, join_window_s=window, health=h)


# -- joiner scenarios: each returns what the two packages must agree on --


def _scn_duplicates(pkg, root):
    imp, out, h, j = _joiner(pkg, root, _pinned(pkg, 10.0), 2.0)
    _imp_shard(pkg, imp, 0, [0, 1, 2])
    _imp_shard(pkg, imp, 1, [2, 3, 4])      # iid 2 again: the copy drops
    paths = j.pump(100.0)
    return h.snapshot(), paths, out


def _scn_past_window(pkg, root):
    feed = _pinned(pkg, 5.0)
    imp, out, h, j = _joiner(pkg, root, feed, 2.0)
    _imp_shard(pkg, imp, 0, [0, 1])
    j.pump(0.0)
    feed.push(0, 1.0, served_at_s=0.0)       # arrives at t=5, window 2
    paths = j.pump(10.0)
    return h.snapshot(), paths, out


def _scn_late_and_orphan(pkg, root):
    feed = _pinned(pkg, 1.0)
    imp, out, h, j = _joiner(pkg, root, feed, 2.0)
    feed.push(0, 1.0, served_at_s=0.0)       # polled before its impression
    j.pump(1.5)
    _imp_shard(pkg, imp, 0, [0, 1])
    feed.push(1, 1.0, served_at_s=0.0)
    feed.push(999, 1.0, served_at_s=0.0)     # never logged anywhere
    paths = j.pump(5.0)
    return h.snapshot(), paths, out


def _scn_torn(pkg, root):
    feed = _pinned(pkg, 1.0)
    imp, out, h, j = _joiner(pkg, root, feed, 2.0)
    _imp_shard(pkg, imp, 0, [0, 1, 2])
    torn = _imp_shard(pkg, imp, 1, [3, 4, 5])
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) - 7)
    for iid in (0, 1, 2, 3, 4):
        feed.push(iid, float(iid % 2), served_at_s=0.0)
    paths = j.pump(1.5)
    return h.snapshot(), paths, out


def _scn_restart(pkg, root):
    feed = _pinned(pkg, 1.0)
    imp, out, h, j = _joiner(pkg, root, feed, 2.0)
    _imp_shard(pkg, imp, 0, [0, 1])
    feed.push(0, 1.0, served_at_s=0.0)
    feed.push(1, 0.0, served_at_s=0.0)
    first = j.pump(1.5)
    # A fresh joiner over the same directories: the output shard is its
    # durable state (no re-emission), the manifest reloads, and emission
    # goes on in order.
    feed2 = _pinned(pkg, 1.0)
    h2 = pkg["health"].LoopHealth()
    j2 = pkg["join"].DelayedLabelJoiner(imp, out, feed2, join_window_s=2.0,
                                        health=h2)
    j2.pump(1.5)
    _imp_shard(pkg, imp, 1, [2, 3])
    feed2.push(2, 1.0, served_at_s=0.0)
    second = j2.pump(3.0)
    counters = {"first": h.snapshot(), "second": h2.snapshot(),
                "manifests": {os.path.basename(k): v
                              for k, v in j2.manifests.items()}}
    return counters, first + second, out


def _scn_cadence(pkg, root):
    # Coarse and fine pumping classify the same way.
    out_all = {}
    for pumps in ([10.0], [1.0, 3.0, 6.0, 10.0]):
        sub = os.path.join(root, f"c{len(pumps)}")
        feed = _pinned(pkg, 5.0)
        imp, out, h, j = _joiner(pkg, sub, feed, 2.0)
        _imp_shard(pkg, imp, 0, [0])
        feed.push(0, 1.0, served_at_s=0.0)
        for now in pumps:
            j.pump(now)
        out_all[len(pumps)] = h.snapshot()
    return out_all, [], out


def _scn_seeded_delays(pkg, root):
    # Seeded delays across the window edge, labels pushed in a shuffled
    # order, finalize closing what is still open.
    feed = pkg["join"].SeededLabelFeed(7, delay_min_s=0.2,
                                       delay_max_s=4.0)
    imp, out, h, j = _joiner(pkg, root, feed, 2.0)
    _imp_shard(pkg, imp, 0, list(range(0, 6)))
    _imp_shard(pkg, imp, 1, list(range(6, 12)))
    order = np.random.default_rng(3).permutation(12)
    for iid in order:
        feed.push(int(iid), float(iid % 3 == 0), served_at_s=0.0)
    paths = j.pump(1.0) + j.pump(2.5) + j.finalize(2.5)
    return h.snapshot(), paths, out


SCENARIOS = {f.__name__[5:]: f for f in (
    _scn_duplicates, _scn_past_window, _scn_late_and_orphan, _scn_torn,
    _scn_restart, _scn_cadence, _scn_seeded_delays)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_joiner_matches_jax(tmp_path, name):
    """Emitted ``tr`` shards and manifests byte-identical, the same paths
    and the same ``LoopHealth`` counters (tolerance: none)."""
    got = {}
    for pkg_name, pkg in PKGS.items():
        root = str(tmp_path / pkg_name)
        counters, paths, out = SCENARIOS[name](pkg, root)
        got[pkg_name] = (counters, [os.path.relpath(p, root) for p in paths],
                         _dir_bytes(out) if os.path.isdir(out) else {})
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2]
    assert got["port"][2], "the scenario emitted nothing"


@pytest.mark.parametrize("stamps", [
    {}, {"trace_id": 77}, {"model_version": 12},
    {"arm": 1, "pred": 0.3125}, {"trace_id": 5, "model_version": 3,
                                 "arm": 0, "pred": 0.1}])
def test_encode_impression_bytes_equal(stamps):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 117_581, 39).astype(np.int32)
    vals = rng.normal(size=39).astype(np.float32)
    a = jax_imp.encode_impression(123456, 17.25, ids, vals, **stamps)
    b = impressions.encode_impression(123456, 17.25, ids, vals, **stamps)
    assert a == b
    assert impressions.read_correlation(b) == jax_imp.read_correlation(a)
    assert impressions.read_experiment(b) == jax_imp.read_experiment(a)
    j_iid, j_at, j_ids, j_vals = jax_imp.decode_impression(a)
    p_iid, p_at, p_ids, p_vals = impressions.decode_impression(b)
    assert (p_iid, p_at) == (j_iid, j_at)
    assert np.array_equal(p_ids, j_ids) and p_vals.tobytes() == \
        j_vals.tobytes()


def test_impression_logger_shards_byte_identical(tmp_path):
    """Both loggers, fed the same requests (some stamped, one partial shard
    left for ``close``), write the same shard files, and resume after
    existing shards to the same index."""
    plan = traffic.DiurnalTrafficPlan(
        5, duration_s=3.0, base_qps=6.0, peak_qps=15.0, feature_size=64,
        field_size=FIELD, max_rows=4)
    out = {}
    for pkg_name, pkg in (("jax", jax_imp), ("port", impressions)):
        d = str(tmp_path / pkg_name)
        logger = pkg.ImpressionLogger(d, shard_records=5)
        for k, req in enumerate(plan.requests):
            kw = {}
            if k % 3 == 1:
                kw = dict(trace_id=1000 + k, model_version=k // 4,
                          arm=k % 2, preds=np.full(req.ids.shape[0], 0.25,
                                                   np.float32))
            logger.log_request(req.first_id, req.ids, req.vals, req.t_s,
                               **kw)
        logger.close()
        again = pkg.ImpressionLogger(d, shard_records=2)
        again.log(10 ** 6, *_row(1), served_at_s=1.0)
        again.close()
        out[pkg_name] = (_dir_bytes(d), [os.path.basename(s)
                                         for s in again.shards])
        got = [r[0] for s in logger.shards
               for r in pkg.iter_impressions(s)]
        assert got == list(range(plan.total_rows))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) > 2


@pytest.mark.parametrize("seed", [0, 3, 11, 2026])
def test_diurnal_plan_fingerprint_equal(seed):
    kw = dict(duration_s=8.0, base_qps=8.0, peak_qps=30.0, feature_size=64,
              field_size=5, max_rows=4)
    a = jax_traffic.DiurnalTrafficPlan(seed, **kw)
    b = traffic.DiurnalTrafficPlan(seed, **kw)
    assert b.fingerprint_data() == a.fingerprint_data()
    assert b.total_rows == a.total_rows


def test_diurnal_plan_reference_width_equal():
    kw = dict(duration_s=4.0, base_qps=6.0, peak_qps=22.0,
              feature_size=117_581, field_size=39, max_rows=6)
    a = jax_traffic.DiurnalTrafficPlan(2026, **kw)
    b = traffic.DiurnalTrafficPlan(2026, **kw)
    assert b.fingerprint_data() == a.fingerprint_data()


@pytest.mark.parametrize("seed,repeat_p", [(7, 0.0), (8, 0.5), (3, 0.2)])
def test_flood_plan_fingerprint_equal(seed, repeat_p):
    def plan(mod):
        pop = mod.ZipfUserPopulation(seed, users=5_000, hist_len=6)
        return mod.FloodTrafficPlan(
            seed + 1, offered_qps=120.0, duration_s=1.5, population=pop,
            field_size=5, feature_size=64, repeat_p=repeat_p), pop
    (a, pa), (b, pb) = plan(jax_traffic), plan(traffic)
    assert b.fingerprint_data() == a.fingerprint_data()
    assert (b.repeat_requests, pb.touched_users) == \
        (a.repeat_requests, pa.touched_users)


def test_zipf_population_draws_and_histories_equal():
    a = jax_traffic.ZipfUserPopulation(9, users=1_000_000, hist_len=5)
    b = traffic.ZipfUserPopulation(9, users=1_000_000, hist_len=5)
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(20):
        ua, ub = a.sample_users(ra, 7), b.sample_users(rb, 7)
        ia, ib = a.sample_items(ra, 7), b.sample_items(rb, 7)
        assert np.array_equal(ua, ub) and np.array_equal(ia, ib)
        for u, i in zip(ua.tolist(), ia.tolist()):
            ha, hb = a.history(u), b.history(u)
            assert all(np.array_equal(x, y) for x, y in zip(ha, hb))
            a.click(u, i)
            b.click(u, i)
    assert a.touched_users == b.touched_users > 0


def _emit_one(pkg, root, served):
    imp, out = os.path.join(root, "imp"), os.path.join(root, "out")
    feed = _pinned(pkg, 1.0)
    j = pkg["join"].DelayedLabelJoiner(imp, out, feed, join_window_s=2.0)
    _imp_shard(pkg, imp, 0, sorted(served))
    for iid in served:
        feed.push(iid, 1.0, served_at_s=0.0)
    (path,) = j.pump(1.5)
    return path


@pytest.mark.parametrize("drift", ["none", "ulp", "ids", "unserved"])
def test_skew_checker_verdicts_equal(tmp_path, drift):
    """The same verdicts (ok, records audited, mismatch texts up to the
    shard's path), the single-ulp drift included."""
    verdicts = {}
    for pkg_name, pkg in PKGS.items():
        root = str(tmp_path / pkg_name)
        served = {iid: _row(iid) for iid in range(4)}
        path = _emit_one(pkg, root, served)
        ids, vals = served[2]
        if drift == "ulp":
            v = vals.copy()
            v[0] = np.nextafter(v[0], np.float32(np.inf))
            served[2] = (ids, v)
        elif drift == "ids":
            served[2] = (ids + 1, vals)
        elif drift == "unserved":
            del served[2]
        ck = pkg["skew"].SkewChecker(served)
        n = ck.audit_shard(path)
        verdicts[pkg_name] = (ck.ok, n, ck.records_audited,
                              [m.replace(root, "") for m in ck.mismatches])
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][0] == (drift == "none")


def _samples(seed, n=300):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    y = (rng.random(n) < 0.3).astype(np.float64)
    p = np.clip(0.3 + 0.2 * (y - 0.3) + rng.normal(0, 0.2, n), 0, 1)
    p[::17] = 0.5                                # ties: midranks
    b = rng.random(n)
    return [(float(a), float(c), float(d), float(e))
            for a, c, d, e in zip(t, y, p, b)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    """``exact_auc``, ``windowed_auc``, ``arm_health``, ``percentile`` and
    ``staleness_summary`` are float64 numpy in both packages: equal."""
    s = _samples(seed)
    p = [x[2] for x in s]
    y = [x[1] for x in s]
    a, b = jax_metrics.exact_auc(p, y), metrics.exact_auc(p, y)
    assert a == b
    assert metrics.windowed_auc(s, 4, 10.0) == \
        jax_metrics.windowed_auc(s, 4, 10.0)
    rng = np.random.default_rng(seed + 10)
    arms = [(int(rng.integers(0, 2)), c, d, float(rng.uniform(0, 30)))
            for _, c, d, _ in s]
    arms[5] = (1, 1.0, float("nan"), 2.0)        # a non-finite prediction
    assert metrics.arm_health(arms) == jax_metrics.arm_health(arms)
    lat = [x[3] * 3 for x in s]
    for q in (50, 95, 99):
        assert metrics.percentile(lat, q) == jax_metrics.percentile(lat, q)
    assert metrics.staleness_summary(lat) == \
        jax_metrics.staleness_summary(lat)
    assert metrics.staleness_summary([]) == jax_metrics.staleness_summary([])


def test_metrics_edge_cases_equal():
    for p, y in (([0.5, 0.5], [0, 1]), ([0.1, 0.2], [1, 1]), ([], [])):
        a, b = jax_metrics.exact_auc(p, y), metrics.exact_auc(p, y)
        assert (np.isnan(a) and np.isnan(b)) or a == b
    one_class = [(0, 1.0, 0.4, 1.0), (0, 1.0, 0.6, 2.0)]
    assert metrics.arm_health(one_class) == jax_metrics.arm_health(one_class)
    assert metrics.arm_health([]) == jax_metrics.arm_health([])


def test_label_feed_delays_equal():
    a = jax_join.SeededLabelFeed(3, delay_min_s=0.5, delay_max_s=6.0)
    b = join.SeededLabelFeed(3, delay_min_s=0.5, delay_max_s=6.0)
    assert [b.delay_for(i) for i in range(500)] == \
        [a.delay_for(i) for i in range(500)]
    for iid in range(40):
        a.push(iid, float(iid % 2), served_at_s=iid * 0.1)
        b.push(iid, float(iid % 2), served_at_s=iid * 0.1)
    assert b.poll(3.0) == a.poll(3.0)
    assert b.poll(100.0) == a.poll(100.0)
    assert b.pending == a.pending == 0


def test_loop_health_counters_equal():
    a, b = jax_health.LoopHealth(), health.LoopHealth()
    for name in ("labels_joined", "labels_late", "joined_shards"):
        a.record(name, 3)
        b.record(name, 3)
    assert b.snapshot() == a.snapshot()
    ta, tb = {"x": 1}, {"x": 1}
    a.merge_into(ta)
    b.merge_into(tb)
    assert tb == ta
    assert b.summary() == a.summary()
    with open(os.devnull, "w") as f:
        json.dump(b.snapshot(), f)
