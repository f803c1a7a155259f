"""The port's replica fleet (``deepfm_tpu_torch.serve.replicas``) against
the JAX package's ``deepfm_tpu.serve.replicas`` on the CPU.

* Routing behaviour (sticky affinity, least-loaded spill, the typed
  all-refused ``ServerOverloaded``/``AdmissionShed``, dead replicas,
  hedging on an injected clock, drain on close): each scenario runs on
  both packages' fleets over the same host predict function and must give
  the same routed counts, spills, pending rows, results and error types
  (tolerance: none).
* ``check_swaps_once``: one replica at a time, in order, over real
  watchers of a publish dir (``start=False``, no per-replica threads).
* Model answers: a ``ReplicatedEngine.serve_latest`` fleet over an
  artifact carried from JAX weights answers, on each replica, as the JAX
  ``ServingEngine`` over the JAX serving function does, within the port's
  serving tolerance for a float32 tower (``tests/test_torch_serving.py``:
  rtol 1e-6, atol 1e-6).
"""

import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import deepfm_tpu.serve as jax_serve
from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data.shm_ring import THREAD_CTX as JAX_THREAD_CTX
from deepfm_tpu.models import DeepFM as JaxDeepFM
from deepfm_tpu.serve import replicas as jax_replicas
from deepfm_tpu.utils import export as jax_export
import deepfm_tpu_torch.serve as port_serve
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data.shm_ring import THREAD_CTX
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.serve import replicas as port_replicas
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)

FIELD_SIZE = 3
SERVE_TOL = dict(rtol=1e-6, atol=1e-6)   # float32 tower, as test_torch_serving

PKGS = {
    "jax": types.SimpleNamespace(serve=jax_serve, replicas=jax_replicas,
                                 ctx=JAX_THREAD_CTX),
    "port": types.SimpleNamespace(serve=port_serve, replicas=port_replicas,
                                  ctx=THREAD_CTX),
}


def _rows(n, base=0):
    return (np.full((n, FIELD_SIZE), base, np.int32),
            np.ones((n, FIELD_SIZE), np.float32))


def base_predict(feat_ids, feat_vals):
    return feat_ids[:, 0].astype(np.float32) + 0.5 * feat_vals[:, 0]


def _fleet(pkg, n=2, start=True, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_delay_ms", 1)
    return pkg.serve.ReplicatedEngine(
        [pkg.serve.ServingEngine(base_predict, start=start, **kw)
         for _ in range(n)])


def _start_and_close(fleet):
    for e in fleet.engines:
        e.start()
    fleet.close(timeout=30)


def _err(fn):
    """The error type's name and whether its text names the fleet."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, "all 2 replicas" in str(e)
    return None


# -- scenarios: each returns what the two packages must agree on ----------


def _scn_sticky(pkg):
    fleet = _fleet(pkg, 3)
    try:
        out = []
        for _ in range(4):
            out.append(fleet.predict(*_rows(2, base=1), timeout=10,
                                     affinity=7).tolist())
        for other in (0, 1, 2, 5):
            fleet.predict(*_rows(1), timeout=10, affinity=other)
        fleet.predict(*_rows(2, base=1), timeout=10, affinity=7)
        return out, list(fleet.routed), fleet.spills
    finally:
        fleet.close(timeout=10)


def _scn_least_loaded(pkg):
    fleet = _fleet(pkg, 2, start=False)
    try:
        fleet.engines[0].submit(*_rows(6))
        fut = fleet.submit(*_rows(2))
        return list(fleet.routed), [e.pending_rows for e in fleet.engines], \
            fut.done()
    finally:
        _start_and_close(fleet)


def _scn_spill(pkg):
    fleet = _fleet(pkg, 2, start=False, max_batch=4, queue_rows=4)
    try:
        fleet.submit(*_rows(4), affinity=0)
        fleet.submit(*_rows(2), affinity=0)
        return list(fleet.routed), fleet.spills
    finally:
        _start_and_close(fleet)


def _scn_spill_burst(pkg):
    fleet = _fleet(pkg, 3, start=False, max_batch=8, queue_rows=8)
    try:
        fleet.engines[0].submit(*_rows(8))
        for _ in range(3):
            fleet.submit(*_rows(4), affinity=0)
        return list(fleet.routed), fleet.spills, \
            [e.pending_rows for e in fleet.engines]
    finally:
        _start_and_close(fleet)


def _scn_all_refuse_overloaded(pkg):
    fleet = _fleet(pkg, 2, start=False, max_batch=4, queue_rows=4)
    try:
        fleet.submit(*_rows(4), affinity=0)
        fleet.submit(*_rows(4), affinity=1)
        return _err(lambda: fleet.submit(*_rows(1))), list(fleet.routed)
    finally:
        _start_and_close(fleet)


def _scn_all_refuse_shed(pkg):
    fleet = pkg.serve.ReplicatedEngine(
        [pkg.serve.ServingEngine(base_predict, start=False, max_batch=8,
                                 max_delay_ms=1, queue_rows=8,
                                 admission_kw={"shed_watermark": 2})
         for _ in range(2)], start=False)
    try:
        for e in fleet.engines:
            e.submit(*_rows(2), value="critical")
        return _err(lambda: fleet.submit(*_rows(1), value="bulk"))
    finally:
        _start_and_close(fleet)


def _scn_dead_replica(pkg):
    fleet = _fleet(pkg, 2)
    fleet.engines[0].close(timeout=10)
    probs = fleet.predict(*_rows(2, base=4), timeout=10, affinity=0)
    routed = list(fleet.routed)
    fleet.close(timeout=10)
    return probs.tolist(), routed, _err(lambda: fleet.submit(*_rows(1)))


def _scn_malformed(pkg):
    fleet = _fleet(pkg, 2)
    try:
        err = _err(lambda: fleet.submit(np.zeros((2, 3), np.int32),
                                        np.zeros((3, 3), np.float32)))
        return err, list(fleet.routed)
    finally:
        fleet.close(timeout=10)


def _scn_drain_on_close(pkg):
    fleet = _fleet(pkg, 3, start=False, max_batch=2, max_delay_ms=0)
    futs = [fleet.submit(*_rows(2, base=i), affinity=i) for i in range(9)]
    routed = list(fleet.routed)
    _start_and_close(fleet)
    return routed, [f.result(timeout=0).tolist() for f in futs]


class _Clock:
    """The fleet's injected clock (the engines keep the real one, which
    their batchers' deadlines need)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scn_hedge(pkg):
    """Hedging on an injected clock: nothing fires before the delay, one
    hedge after it, to the other replica, which wins."""
    clock = _Clock()
    engines = [pkg.serve.ServingEngine(base_predict, start=False,
                                       max_batch=8, max_delay_ms=1)
               for _ in range(2)]
    fleet = pkg.serve.ReplicatedEngine(engines, hedge_ms=5.0, start=False,
                                       clock=clock)
    try:
        hf = fleet.submit(*_rows(1, base=3), affinity=0)
        clock.t = hf.t_enqueue     # the fleet's clock, from the submit on
        fired = [fleet.hedge_pass()]
        clock.t += 0.004
        fired.append(fleet.hedge_pass())
        clock.t += 0.002
        fired.append(fleet.hedge_pass())
        fired.append(fleet.hedge_pass())          # never twice
        pending = [e.pending_rows for e in fleet.engines]
        fleet.engines[1].start()
        probs = hf.result(timeout=10).tolist()
        clock.t += 1.0
        fleet.hedge_pass()
        s = fleet.summary()
        return (type(hf).__name__, fired, pending, probs,
                hf._primary.cancelled(), round(hf.latency_ms, 6),
                s["hedges_fired"], s["hedges_won"], s["hedges_cancelled"],
                len(fleet._recent_latencies))
    finally:
        _start_and_close(fleet)


def _scn_hedge_both_fail(pkg):
    clock = _Clock()
    engines = [pkg.serve.ServingEngine(base_predict, start=False,
                                       max_batch=8, max_delay_ms=1)
               for _ in range(2)]
    fleet = pkg.serve.ReplicatedEngine(engines, hedge_ms=5.0, start=False,
                                       clock=clock)
    try:
        hf = fleet.submit(*_rows(1, base=4), affinity=0)
        clock.t = hf.t_enqueue + 1.0
        fleet.hedge_pass()
        hf._primary.set_error(RuntimeError("primary boom"))
        held = hf.done()
        hf._hedge.set_error(RuntimeError("hedge boom"))
        return held, hf.done(), _err(lambda: hf.result(timeout=0)), \
            fleet.summary()["hedges_won"]
    finally:
        _start_and_close(fleet)


def _scn_hedge_delay_tracks_p99(pkg):
    fleet = _fleet(pkg, 2, start=False)
    fleet = pkg.serve.ReplicatedEngine(fleet.engines, hedge_ms=5.0,
                                       start=False)
    try:
        out = [fleet.hedge_delay_s()]
        fleet._recent_latencies.extend([100.0] * 19)
        out.append(fleet.hedge_delay_s())
        fleet._recent_latencies.append(100.0)
        out.append(fleet.hedge_delay_s())
        return out
    finally:
        _start_and_close(fleet)


def _scn_frontend_affinity(pkg):
    fleet = _fleet(pkg, 2)
    srv = pkg.serve.FrontendServer(fleet, 2, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        got = []
        with pkg.serve.ServingClient(srv.handle(0)) as c0, \
                pkg.serve.ServingClient(srv.handle(1)) as c1:
            for base in (1, 2, 3):
                got.append(c0.predict(*_rows(2, base=base),
                                      timeout=10).tolist())
                got.append(c1.predict(*_rows(1, base=base),
                                      timeout=10).tolist())
        t.join(timeout=10)
        return got, list(fleet.routed), fleet.spills, t.is_alive()
    finally:
        srv.stop()
        srv.close()
        fleet.close(timeout=10)


SCENARIOS = {f.__name__[5:]: f for f in (
    _scn_sticky, _scn_least_loaded, _scn_spill, _scn_spill_burst,
    _scn_all_refuse_overloaded, _scn_all_refuse_shed, _scn_dead_replica,
    _scn_malformed, _scn_drain_on_close, _scn_hedge, _scn_hedge_both_fail,
    _scn_hedge_delay_tracks_p99, _scn_frontend_affinity)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_behaviour_matches_jax(name):
    jax_out = SCENARIOS[name](PKGS["jax"])
    port_out = SCENARIOS[name](PKGS["port"])
    assert port_out == jax_out


def test_typed_all_refused_errors():
    """The fleet's two all-refused errors are the port's own types."""
    err = SCENARIOS["all_refuse_overloaded"](PKGS["port"])[0]
    assert err == ("ServerOverloaded", True)
    assert SCENARIOS["all_refuse_shed"](PKGS["port"]) == ("AdmissionShed",
                                                          True)


def test_staggered_swap_order_matches_jax():
    """A fake watcher per replica records the walk: sequential, in order,
    never two replicas mid-swap; a raising watcher counts an error and
    does not stop the walk."""
    out = {}
    for name, pkg in PKGS.items():
        active, overlap, order = [], [], []

        class FakeWatcher:
            def __init__(self, tag, boom=False):
                self.tag, self.boom = tag, boom

            def check_once(self):
                if self.boom:
                    raise RuntimeError("poll boom")
                if active:
                    overlap.append((active[0], self.tag))
                active.append(self.tag)
                time.sleep(0.005)
                order.append(self.tag)
                active.pop()
                return True

        fleet = _fleet(pkg, 3)
        try:
            for i, eng in enumerate(fleet.engines):
                eng._watcher = FakeWatcher(f"r{i}", boom=(i == 1))
            swapped = fleet.check_swaps_once()
            out[name] = (swapped, order, overlap,
                         [e.stats.watcher_errors for e in fleet.engines])
        finally:
            for eng in fleet.engines:
                eng._watcher = None
            fleet.close(timeout=10)
    assert out["port"] == out["jax"] == (2, ["r0", "r2"], [], [0, 1, 0])


# -- the model path: serve_latest over an artifact from JAX weights --------

V, F, K = 120, 5, 4


def _jax_model(seed=0):
    jcfg = JaxConfig(feature_size=V, field_size=F, embedding_size=K,
                     deep_layers="8", dropout="1.0", compute_dtype="float32",
                     seed=3)
    jmodel = JaxDeepFM(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    jserve = jax.jit(jax_export._serving_fn(jmodel, jcfg))
    return params, state, (lambda ids, vals: np.asarray(
        jserve(params, state, ids, vals)))


def _port_artifact(params, state, out_dir, step):
    cfg = Config(feature_size=V, field_size=F, embedding_size=K,
                 deep_layers="8", dropout="1.0", compute_dtype="float32",
                 seed=3)
    model = get_model(cfg, device="cpu")
    p, s = params_from_jax(params, state)
    model.load_state_dict({**p, **s})
    return export_lib.export_serving(model, cfg, out_dir, step=step)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = int(rng.integers(1, 12))
        out.append((rng.integers(0, V, (rows, F)).astype(np.int32),
                    rng.normal(size=(rows, F)).astype(np.float32)))
    return out


def test_replicas_answer_as_the_jax_engine(tmp_path):
    params, state, jfn = _jax_model()
    pub = str(tmp_path / "publish")
    _port_artifact(params, state, os.path.join(pub, "1"), 1)
    export_lib.write_latest(pub, "1")
    jeng = jax_serve.ServingEngine(jfn, max_batch=16, max_delay_ms=1)
    fleet = port_serve.ReplicatedEngine.serve_latest(
        pub, replicas=2, poll_secs=3600, max_batch=16, max_delay_ms=1,
        inflight=2, small_rows=4, device="cpu")
    try:
        reqs = _requests(24, seed=5)
        for i, (ids, vals) in enumerate(reqs):
            want = jeng.predict(ids, vals, timeout=60)
            got = fleet.predict(ids, vals, timeout=60, affinity=i % 2)
            assert got.shape == want.shape == (ids.shape[0],)
            np.testing.assert_allclose(got, want, **SERVE_TOL)
        # Affinity i % 2 pins request i to replica i % 2: both answered.
        assert fleet.routed == [12, 12] and fleet.spills == 0
        s = fleet.summary()
        assert s["replicas"] == 2 and s["serving_failed"] == 0
        assert all(p and p > 0 for p in s["prewarmed_buckets_per_replica"])
    finally:
        fleet.close(timeout=30)
        jeng.close(timeout=30)


def test_check_swaps_once_swaps_one_replica_at_a_time(tmp_path):
    """Real watchers (``start=False``): a new version lands on replica 0,
    then replica 1, in one pass; the next pass swaps nothing; answers then
    follow the JAX engine over the new weights."""
    p1, s1, _ = _jax_model(seed=0)
    p2, s2, jfn2 = _jax_model(seed=1)
    pub = str(tmp_path / "publish")
    _port_artifact(p1, s1, os.path.join(pub, "1"), 1)
    export_lib.write_latest(pub, "1")
    fleet = port_serve.ReplicatedEngine.serve_latest(
        pub, replicas=2, poll_secs=3600, max_batch=16, max_delay_ms=1,
        device="cpu")
    try:
        assert all(e.watcher._thread is None for e in fleet.engines)
        order = []
        for i, e in enumerate(fleet.engines):
            w = e.watcher
            orig = w.check_once

            def check(orig=orig, i=i):
                order.append(("begin", i))
                out = orig()
                order.append(("end", i))
                return out
            w.check_once = check
        _port_artifact(p2, s2, os.path.join(pub, "2"), 2)
        export_lib.write_latest(pub, "2")
        assert fleet.check_swaps_once() == 2
        assert order == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1)]
        assert [os.path.basename(e.watcher.current_path)
                for e in fleet.engines] == ["2", "2"]
        assert fleet.check_swaps_once() == 0
        ids, vals = _requests(1, seed=9)[0]
        for r in range(2):
            np.testing.assert_allclose(
                fleet.predict(ids, vals, timeout=60, affinity=r),
                jfn2(ids, vals), **SERVE_TOL)
    finally:
        fleet.close(timeout=30)


# -- the serving drill --------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_serving_drill(tmp_path, replicas):
    """The port's serving drill on the CPU at the JAX drill's model: a live
    publisher, >= 2 hot swaps on every replica with zero failures, each
    replica's blackout under the bound, padded answers bit-equal to
    unpadded ones; with two replicas, two spawned frontend clients too."""
    from deepfm_tpu_torch.drills import serving
    r = serving.run_drill(str(tmp_path), verbose=False, replicas=replicas,
                          frontend_clients=2 if replicas > 1 else 0,
                          device="cpu")
    assert r["ok"] and r["replicas"] == replicas
    assert r["hot_swaps"] >= serving.MIN_SWAPS
    assert r["serving_failed"] == 0 and r["swap_failures"] == 0
    assert len(r["swap_blackout_ms_per_replica"]) == replicas
    assert all(b < serving.MAX_BLACKOUT_MS
               for b in r["swap_blackout_ms_per_replica"])
    assert r["versions_published"] == [4, 8, 12, 16]
    if replicas > 1:
        f = r["frontend"]
        assert {k: f[k] for k in ("clients", "exit_codes", "responses",
                                  "errors", "timeouts",
                                  "dropped_dead_client")} == {
            "clients": 2, "exit_codes": [0, 0],
            "responses": 2 * serving.FRONTEND_REQUESTS,
            "errors": 0, "timeouts": 0, "dropped_dead_client": 0}
        assert f["serving_s"] > 0 and f["spawn_s"] > 0
        assert f["spawn_s"] + f["serving_s"] <= f["wall_s"]
        assert f["requests_per_s"] == f["responses"] / f["serving_s"]
