"""The port's serving path on the CPU: artifact export/load against the JAX
package's serving function, bucketed padding parity, the serving engine
(batcher policy, demux, hot swap) and the chip smoke's serve phase at a
small size.

The engine cases mirror ``tests/test_serving.py`` on the port's copy of the
engine.
"""

import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.models import DeepFM as JaxDeepFM
from deepfm_tpu.utils import export as jax_export
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.ops.fused_fm import fused_fm
from deepfm_tpu_torch.serve import (ServerOverloaded, ServeTimeout,
                                    ServingEngine)
from deepfm_tpu_torch.utils import export as export_lib
from deepfm_tpu_torch.utils import faults as faults_lib
from deepfm_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)

V, F, K = 120, 5, 4


def _cfg_kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="8", dropout="1.0", compute_dtype="float32",
                seed=3)
    base.update(kw)
    return base


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (n, F)).astype(np.int32),
            rng.normal(size=(n, F)).astype(np.float32))


def _publish(publish_dir, version, seed=0, **kw):
    """Export a seeded port model as ``<publish_dir>/<version>``."""
    cfg = Config(**_cfg_kw(**kw))
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    return export_lib.export_serving(
        model, cfg, os.path.join(publish_dir, version), step=seed)


def _cpu_loader(buckets):
    return lambda path: export_lib.load_serving(path, buckets=buckets,
                                                device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _publish(str(tmp_path_factory.mktemp("serve")), "1", seed=1)


# ---------------------------------------------------------------------------
# Artifact: port export -> port load vs the JAX serving function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype,tol", [
    ("float32", dict(rtol=1e-6, atol=1e-6)),
    # bfloat16 towers: one bf16 ulp of a logit, at most 2^-8 / 4 in prob.
    ("bfloat16", dict(rtol=0, atol=2 ** -10)),
])
def test_load_serving_matches_jax_serving_fn(tmp_path, compute_dtype, tol):
    jcfg = JaxConfig(**_cfg_kw(compute_dtype=compute_dtype))
    jmodel = JaxDeepFM(jcfg)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    jserve = jax.jit(jax_export._serving_fn(jmodel, jcfg))

    cfg = Config(**_cfg_kw(compute_dtype=compute_dtype))
    model = get_model(cfg, device="cpu")
    p, s = params_from_jax(params, state)
    model.load_state_dict({**p, **s})
    out = export_lib.export_serving(model, cfg, str(tmp_path / "1"))
    served = export_lib.load_serving(out, buckets=(1, 4, 16), device="cpu")

    for n in (1, 3, 16):
        ids, vals = _batch(n, seed=n)
        got = served(ids, vals)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_allclose(
            got, np.asarray(jserve(params, state, ids, vals)), **tol)


def test_artifact_layout(artifact):
    assert sorted(os.listdir(artifact)) == [
        "ARTIFACT_COMPLETE", "model_config.json", "params.pt"]
    weights = torch.load(os.path.join(artifact, "params.pt"),
                         weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in weights.values())
    assert {"fm_b", "fm_w", "fm_v", "tower.out.w"} <= set(weights)
    with open(os.path.join(artifact, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["signature"] == {
        "inputs": {"feat_ids": ["batch", F, "int32"],
                   "feat_vals": ["batch", F, "float32"]},
        "outputs": {"prob": ["batch", "float32"]}}
    # model_config.json means the same thing to both packages.
    assert JaxConfig.from_dict(meta["config"]) == JaxConfig(**_cfg_kw())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_bucketed_output_equals_unpadded(tmp_path, compute_dtype):
    """Padded-bucket probs are bit-equal to the unpadded call, row for row.
    (n=1 runs in bucket 1: BLAS takes another kernel for one row.)"""
    out = _publish(str(tmp_path), "1", compute_dtype=compute_dtype)
    raw = export_lib.load_serving(out, device="cpu")
    bucketed = export_lib.load_serving(out, buckets=(1, 4, 16), device="cpu")
    for n in (1, 2, 3, 7, 16):
        ids, vals = _batch(n, seed=n)
        np.testing.assert_array_equal(bucketed(ids, vals), raw(ids, vals))
    assert bucketed.calls_per_bucket == {1: 1, 4: 2, 16: 2}


def test_incomplete_artifact_refuses_to_load(tmp_path, artifact):
    torn = tmp_path / "torn"
    torn.mkdir()
    for name in ("model_config.json", "params.pt"):
        (torn / name).write_bytes(open(os.path.join(artifact, name), "rb").read())
    with pytest.raises(export_lib.ArtifactIncomplete, match="incomplete"):
        export_lib.load_serving(str(torn), device="cpu")


def test_latest_pointer(tmp_path):
    assert export_lib.read_latest(str(tmp_path)) is None
    export_lib.write_latest(str(tmp_path), "7")
    assert export_lib.read_latest(str(tmp_path)) is None   # dangling
    os.makedirs(tmp_path / "7")
    assert export_lib.read_latest(str(tmp_path)) == str(tmp_path / "7")
    export_lib.write_latest(str(tmp_path), "")
    assert export_lib.read_latest(str(tmp_path)) is None   # empty pointer


# ---------------------------------------------------------------------------
# Engine over a real artifact
# ---------------------------------------------------------------------------

def test_engine_demuxes_real_model_row_for_row(artifact):
    fn = export_lib.load_serving(artifact, device="cpu")
    eng = ServingEngine(fn, max_batch=16, max_delay_ms=10_000, start=False)
    reqs = [_batch(n, seed=10 + n) for n in (2, 5, 9)]
    futs = [eng.submit(ids, vals) for ids, vals in reqs]
    eng.start()
    eng.close(timeout=30)
    for fut, (ids, vals) in zip(futs, reqs):
        probs = fut.result(timeout=0)
        assert probs.shape == (ids.shape[0],)
        assert np.all(np.isfinite(probs))
        assert np.all((probs >= 0) & (probs <= 1))
        np.testing.assert_array_equal(probs, fn(ids, vals))
    assert eng.stats.flushes == 1 and eng.stats.padded_rows == 16


def test_serve_latest_hot_swaps(tmp_path):
    publish = str(tmp_path)
    v1 = _publish(publish, "1", seed=1)
    export_lib.write_latest(publish, "1")
    buckets = export_lib.serving_buckets(8)
    eng = ServingEngine.serve_latest(
        publish, max_batch=8, max_delay_ms=1,
        watcher_kw={"loader": _cpu_loader(buckets), "start": False})
    try:
        assert eng.watcher.prewarmed_buckets == len(buckets)
        ids, vals = _batch(3)
        want1 = export_lib.load_serving(v1, device="cpu")(ids, vals)
        np.testing.assert_array_equal(eng.predict(ids, vals, timeout=30),
                                      want1)
        v2 = _publish(publish, "2", seed=2)
        export_lib.write_latest(publish, "2")
        assert eng.watcher.check_once()
        want2 = export_lib.load_serving(v2, device="cpu")(ids, vals)
        assert not np.array_equal(want1, want2)
        np.testing.assert_array_equal(eng.predict(ids, vals, timeout=30),
                                      want2)
        assert eng.stats.summary()["serving_failed"] == 0
    finally:
        eng.close()


def test_torn_artifact_keeps_current_model(tmp_path):
    publish = str(tmp_path)
    _publish(publish, "1", seed=1)
    export_lib.write_latest(publish, "1")
    watcher = export_lib.watch_latest(publish, start=False,
                                      loader=_cpu_loader((1, 2)))
    os.makedirs(tmp_path / "2")           # no marker: an export in flight
    export_lib.write_latest(publish, "2")
    assert not watcher.check_once()
    assert watcher.swap_failures == 1
    assert watcher.current_path == os.path.join(publish, "1")
    assert watcher(*_batch(2)).shape == (2,)


# ---------------------------------------------------------------------------
# Engine policy (the port's copy of the engine; cases of test_serving.py)
# ---------------------------------------------------------------------------

def _rows(n, base=0):
    ids = (base + np.arange(n * F, dtype=np.int32)).reshape(n, F) % V
    return ids, np.ones((n, F), np.float32)


def first_col_predict(feat_ids, feat_vals):
    """Row-local fake model: prob = f(row) only, like the real serve fn."""
    return feat_ids[:, 0].astype(np.float32) * 0.001 + feat_vals[:, 0] * 0.1


def test_bucket_math():
    assert export_lib.serving_buckets(8) == (1, 2, 4, 8)
    assert export_lib.serving_buckets(12) == (1, 2, 4, 8, 12)
    assert [export_lib.next_bucket(n, (1, 2, 4, 8))
            for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds the largest"):
        export_lib.next_bucket(9, (1, 2, 4, 8))


def test_single_request_deadline_fires():
    eng = ServingEngine(first_col_predict, max_batch=64, max_delay_ms=20)
    try:
        ids, vals = _rows(1)
        np.testing.assert_array_equal(eng.predict(ids, vals, timeout=10),
                                      first_col_predict(ids, vals))
        assert eng.stats.deadline_flushes == 1
    finally:
        eng.close()


def test_queue_full_is_typed_not_a_hang():
    eng = ServingEngine(first_col_predict, max_batch=4, queue_rows=8,
                        start=False)
    for _ in range(2):
        eng.submit(*_rows(4))
    with pytest.raises(ServerOverloaded, match="queue full"):
        eng.submit(*_rows(1))
    assert eng.stats.overloads == 1


def test_close_drains_queue():
    eng = ServingEngine(first_col_predict, max_batch=64,
                        max_delay_ms=60_000, start=False)
    futs = [eng.submit(*_rows(3, base=i)) for i in range(5)]
    eng.start()
    eng.close(timeout=10)
    for f in futs:
        assert f.result(timeout=0).shape == (3,)
    with pytest.raises(ServerOverloaded, match="shut down"):
        eng.submit(*_rows(1))


def test_batched_requests_demuxed_row_for_row():
    eng = ServingEngine(first_col_predict, max_batch=16,
                        max_delay_ms=10_000, start=False)
    reqs = [_rows(n, base=17 * i) for i, n in enumerate((1, 5, 2, 8))]
    futs = [eng.submit(ids, vals) for ids, vals in reqs]
    eng.start()
    eng.close(timeout=10)
    for fut, (ids, vals) in zip(futs, reqs):
        np.testing.assert_array_equal(fut.result(timeout=0),
                                      first_col_predict(ids, vals))
        assert fut.latency_ms is not None and fut.latency_ms >= 0


def test_result_timeout_is_typed():
    eng = ServingEngine(first_col_predict, max_batch=4,
                        max_delay_ms=10_000, start=False)
    fut = eng.submit(*_rows(2))
    with pytest.raises(ServeTimeout, match="2 rows"):
        fut.result(timeout=0.01)
    eng.start()
    eng.close(timeout=10)
    assert fut.result(timeout=0).shape == (2,)


def test_malformed_requests_rejected():
    eng = ServingEngine(first_col_predict, max_batch=4, start=False)
    with pytest.raises(ValueError, match="outside 1..max_batch"):
        eng.submit(*_rows(5))
    with pytest.raises(ValueError, match="one \\[n, F\\] shape"):
        eng.submit(np.zeros((2, 3), np.int32), np.zeros((2, 4), np.float32))


def test_predict_error_fails_only_that_flush():
    calls = {"n": 0}

    def flaky(ids, vals):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fell over")
        return first_col_predict(ids, vals)

    eng = ServingEngine(flaky, max_batch=4, max_delay_ms=5)
    try:
        with pytest.raises(RuntimeError, match="fell over"):
            eng.predict(*_rows(2), timeout=10)
        assert eng.stats.requests_failed == 1
        assert eng.predict(*_rows(2), timeout=10).shape == (2,)
    finally:
        eng.close()


def test_executor_slow_seam_delays_flushes():
    eng = ServingEngine(first_col_predict, max_batch=4, max_delay_ms=1)
    try:
        faults_lib.set_executor_slow(0.05, 1)
        t0 = time.monotonic()
        eng.predict(*_rows(1), timeout=10)
        assert time.monotonic() - t0 >= 0.05
        assert faults_lib.executor_slow_remaining() == 0
    finally:
        faults_lib.set_executor_slow(0.0, 0)
        eng.close()


def test_concurrent_clients_all_answered(artifact):
    fn = export_lib.load_serving(artifact, buckets=(1, 2, 4, 8, 16),
                                 device="cpu")
    eng = ServingEngine(fn, max_batch=16, max_delay_ms=2)
    out, errors = {}, []

    def client(c):
        try:
            for j in range(4):
                ids, vals = _batch(1 + (c + j) % 6, seed=100 * c + j)
                out[(c, j)] = (eng.predict(ids, vals, timeout=30), ids, vals)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        eng.close()
    assert not errors
    for probs, ids, vals in out.values():
        np.testing.assert_allclose(probs, fn(ids, vals), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The chip smoke's serve phase, rehearsed at a small size on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_serve_phase_on_cpu(tmp_path, capsys):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    cfg = Config(feature_size=5000, field_size=F, embedding_size=8,
                 deep_layers="16,8", serve_max_batch=64)
    launches, path = chip_smoke.serve_phase(str(tmp_path), cfg,
                                            torch.device("cpu"), n_requests=24)
    assert launches == 0 == fused_fm.launches   # CPU: the plain version
    assert os.path.exists(os.path.join(path, "ARTIFACT_COMPLETE"))
    assert "serve: requests=24" in capsys.readouterr().out
