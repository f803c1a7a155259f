"""The port's shared-memory serving frontend
(``deepfm_tpu_torch.serve.frontend``) on the CPU.

* In-process clients (thread context) against the JAX package's frontend
  on the same engine behaviour: answers, demux by request id, overload
  as a typed error, a full request ring, shape checks, a dead client
  retired, a per-request timeout and the watchdog's abort on a wedged
  predict. Each scenario runs on both packages and must give the same
  observables (tolerance: none).
* Spawned client processes (``FrontendServer.spawn_client``): answers
  over the rings bit-equal to ``engine.predict`` on the same rows of a
  DeepFM artifact, no client imports torch (the watchdog is imported
  inside ``FrontendServer.serve``, and spawn skips the parent's main
  module), ``client_main`` exits 0, overload and a blown request budget
  come back typed, a wedged predict calls the watchdog's abort, and a
  killed client is retired.
"""

import os
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

import deepfm_tpu.serve as jax_serve
from deepfm_tpu.data.shm_ring import THREAD_CTX as JAX_THREAD_CTX
import deepfm_tpu_torch.serve as port_serve
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data.shm_ring import THREAD_CTX
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.serve import frontend
from deepfm_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)

FIELD_SIZE = 3

PKGS = {
    "jax": types.SimpleNamespace(serve=jax_serve, ctx=JAX_THREAD_CTX),
    "port": types.SimpleNamespace(serve=port_serve, ctx=THREAD_CTX),
}


def _rows(n, base=0):
    return (np.full((n, FIELD_SIZE), base, np.int32),
            np.ones((n, FIELD_SIZE), np.float32))


def base_predict(feat_ids, feat_vals):
    return feat_ids[:, 0].astype(np.float32) + 0.5 * feat_vals[:, 0]


def _serve_bg(srv):
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    return t


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__
    return None


def _scn_two_clients(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    srv = pkg.serve.FrontendServer(eng, 2, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx)
    t = _serve_bg(srv)
    try:
        with pkg.serve.ServingClient(srv.handle(0)) as c0, \
                pkg.serve.ServingClient(srv.handle(1)) as c1:
            p0 = c0.predict(*_rows(4, base=10), timeout=10).tolist()
            p1 = c1.predict(*_rows(2, base=20), timeout=10).tolist()
        t.join(timeout=10)
        return p0, p1, t.is_alive(), srv.responses_sent, srv.errors_sent
    finally:
        srv.stop()
        srv.close()
        eng.close(timeout=5)


def _scn_pipelined(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    srv = pkg.serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx)
    t = _serve_bg(srv)
    try:
        with pkg.serve.ServingClient(srv.handle(0)) as c:
            r = [c.submit(*_rows(k, base=k), timeout=5) for k in (1, 2, 3)]
            return [c.recv(r[i], timeout=10).tolist() for i in (2, 0, 1)]
    finally:
        srv.stop()
        t.join(timeout=10)
        srv.close()
        eng.close(timeout=5)


def _scn_overload_typed(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=2, queue_rows=2,
                                  start=False)
    srv = pkg.serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx)
    t = _serve_bg(srv)
    try:
        with pkg.serve.ServingClient(srv.handle(0)) as c:
            r1 = c.submit(*_rows(2), timeout=5)
            r2 = c.submit(*_rows(1), timeout=5)
            err = _err(lambda: c.recv(r2, timeout=10))
            errors = srv.errors_sent
            eng.start()
            return err, errors, c.recv(r1, timeout=10).tolist()
    finally:
        srv.stop()
        t.join(timeout=10)
        srv.close()
        eng.close(timeout=5)


def _scn_ring_full(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    srv = pkg.serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx, capacity=2)
    c = pkg.serve.ServingClient(srv.handle(0))
    try:
        c.submit(*_rows(1), timeout=0)
        c.submit(*_rows(1), timeout=0)
        return _err(lambda: c.submit(*_rows(1), timeout=0))
    finally:
        c.close()
        srv.close()
        eng.close(timeout=5)


def _scn_shapes(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    srv = pkg.serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx)
    c = pkg.serve.ServingClient(srv.handle(0))
    try:
        return (_err(lambda: c.submit(np.zeros((2, 9), np.int32),
                                      np.zeros((2, 9), np.float32))),
                _err(lambda: c.submit(*_rows(srv.max_rows + 1))))
    finally:
        c.close()
        srv.close()
        eng.close(timeout=5)


def _scn_dead_client(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    alive = {"flag": True}
    srv = pkg.serve.FrontendServer(
        eng, 1, field_size=FIELD_SIZE, ctx=pkg.ctx, capacity=2,
        client_alive=lambda cid: alive["flag"])
    t = _serve_bg(srv)
    try:
        c = pkg.serve.ServingClient(srv.handle(0))
        for _ in range(3):       # never read: the response ring backs up
            c.submit(*_rows(1), timeout=5)
        deadline = time.monotonic() + 10
        while srv.responses_sent < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        alive["flag"] = False
        t.join(timeout=10)
        return t.is_alive(), srv.responses_sent, srv.dropped_dead_client
    finally:
        srv.stop()
        srv.close()
        eng.close(timeout=5)


def _scn_request_timeout(pkg):
    release = threading.Event()

    def slow(ids, vals):
        release.wait(10)
        return base_predict(ids, vals)

    eng = pkg.serve.ServingEngine(slow, max_batch=4, max_delay_ms=1)
    srv = pkg.serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                   ctx=pkg.ctx, request_timeout_s=0.2)
    t = _serve_bg(srv)
    try:
        with pkg.serve.ServingClient(srv.handle(0)) as c:
            err = _err(lambda: c.predict(*_rows(1), timeout=10))
            release.set()
            ok = c.predict(*_rows(2, base=3), timeout=10).tolist()
        t.join(timeout=10)
        return err, srv.timeouts_sent, ok
    finally:
        release.set()
        srv.stop()
        srv.close()
        eng.close(timeout=5)


def _scn_wedged_watchdog(pkg):
    release = threading.Event()

    def wedged(ids, vals):
        release.wait(30)
        return base_predict(ids, vals)

    eng = pkg.serve.ServingEngine(wedged, max_batch=4, max_delay_ms=1)
    fired = []
    srv = pkg.serve.FrontendServer(
        eng, 1, field_size=FIELD_SIZE, ctx=pkg.ctx, timeout_s=0.3,
        abort=lambda dump: (fired.append(dump), srv.stop()))
    t = _serve_bg(srv)
    try:
        c = pkg.serve.ServingClient(srv.handle(0))
        c.submit(*_rows(1), timeout=5)
        t.join(timeout=15)
        return t.is_alive(), len(fired), "serving-frontend" in fired[0]
    finally:
        release.set()
        srv.stop()
        srv.close()
        eng.close(timeout=5)


def _scn_idle_no_false_trip(pkg):
    eng = pkg.serve.ServingEngine(base_predict, max_batch=8, max_delay_ms=2)
    fired = []
    srv = pkg.serve.FrontendServer(
        eng, 1, field_size=FIELD_SIZE, ctx=pkg.ctx, timeout_s=0.2,
        abort=lambda dump: fired.append(dump))
    t = _serve_bg(srv)
    try:
        time.sleep(0.7)
        with pkg.serve.ServingClient(srv.handle(0)) as c:
            got = c.predict(*_rows(2), timeout=10).tolist()
        return len(fired), got
    finally:
        srv.stop()
        t.join(timeout=10)
        srv.close()
        eng.close(timeout=5)


SCENARIOS = {f.__name__[5:]: f for f in (
    _scn_two_clients, _scn_pipelined, _scn_overload_typed, _scn_ring_full,
    _scn_shapes, _scn_dead_client, _scn_request_timeout,
    _scn_wedged_watchdog, _scn_idle_no_false_trip)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_frontend_matches_jax(name):
    jax_out = SCENARIOS[name](PKGS["jax"])
    port_out = SCENARIOS[name](PKGS["port"])
    assert port_out == jax_out


def test_typed_errors_are_the_ports():
    assert SCENARIOS["overload_typed"](PKGS["port"])[0] == "ServerOverloaded"
    assert SCENARIOS["ring_full"](PKGS["port"]) == "ServerOverloaded"
    assert SCENARIOS["request_timeout"](PKGS["port"])[:2] == \
        ("ServeTimeout", 1)


# -- spawned client processes ----------------------------------------------

V, F = 120, 5

# A client target in a module of its own: spawn pickles it by reference,
# and it must not be a test module (which imports torch and jax).
_CLIENT_SRC = textwrap.dedent('''
    import sys
    import numpy as np
    from deepfm_tpu_torch.serve.frontend import ServingClient

    def run(handle, out_path, n_requests, seed, feature_size):
        rng = np.random.default_rng(seed)
        client = ServingClient(handle)
        arrays = {}
        for i in range(n_requests):
            n = int(rng.integers(1, handle.max_rows + 1))
            ids = rng.integers(0, feature_size,
                               (n, handle.field_size)).astype(np.int32)
            vals = rng.normal(size=(n, handle.field_size)).astype(np.float32)
            arrays[f"ids{i}"] = ids
            arrays[f"vals{i}"] = vals
            arrays[f"probs{i}"] = client.predict(ids, vals, timeout=60)
        client.close()
        arrays["torch_loaded"] = np.asarray(
            any(m.split(".")[0] == "torch" for m in sys.modules))
        arrays["jax_loaded"] = np.asarray(
            any(m.split(".")[0] in ("jax", "deepfm_tpu") for m in sys.modules))
        np.savez(out_path, **arrays)

    def typed_errors(handle, out_path):
        client = ServingClient(handle)
        ids = np.zeros((2, handle.field_size), np.int32)
        vals = np.ones((2, handle.field_size), np.float32)
        r1 = client.submit(ids, vals, timeout=60)         # fills the queue
        r2 = client.submit(ids[:1], vals[:1], timeout=60)  # over the bound
        names = []
        for rid in (r2, r1):
            try:
                client.recv(rid, timeout=60)
                names.append("answered")
            except Exception as e:
                names.append(type(e).__name__)
        client.close()
        np.save(out_path, np.asarray(names))

    def hang(handle):
        client = ServingClient(handle)
        ids = np.zeros((1, handle.field_size), np.int32)
        vals = np.ones((1, handle.field_size), np.float32)
        for _ in range(3):      # never read: the response ring backs up
            client.submit(ids, vals, timeout=60)
        import time
        time.sleep(600)
''')


@pytest.fixture
def client_module(tmp_path, monkeypatch):
    d = tmp_path / "clientmod"
    d.mkdir()
    (d / "torch_frontend_client.py").write_text(_CLIENT_SRC)
    monkeypatch.syspath_prepend(str(d))
    import importlib
    mod = importlib.import_module("torch_frontend_client")
    yield mod
    sys.modules.pop("torch_frontend_client", None)


@pytest.fixture(scope="module")
def model_engine(tmp_path_factory):
    cfg = Config(feature_size=V, field_size=F, embedding_size=4,
                 deep_layers="8", dropout="1.0", compute_dtype="float32")
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(4))
    art = export_lib.export_serving(
        model, cfg, str(tmp_path_factory.mktemp("fe") / "1"))
    fn = export_lib.load_serving(art, buckets=export_lib.serving_buckets(16),
                                 device="cpu")
    eng = port_serve.ServingEngine(fn, max_batch=16, max_delay_ms=2)
    yield eng
    eng.close(timeout=10)


def test_spawned_clients_bit_equal_and_torch_free(tmp_path, client_module,
                                                  model_engine):
    srv = port_serve.FrontendServer(model_engine, 3, field_size=F,
                                    slab_records=8)
    t = _serve_bg(srv)
    outs = [str(tmp_path / f"client{c}.npz") for c in range(3)]
    procs = [srv.spawn_client(c, outs[c], 12, 50 + c, V,
                              target=client_module.run) for c in range(3)]
    try:
        for p in procs:
            p.join(timeout=120)
            assert p.exitcode == 0, f"client exit {p.exitcode}"
        t.join(timeout=30)
        assert not t.is_alive()
        assert srv.responses_sent == 36 and srv.errors_sent == 0
        for path in outs:
            z = np.load(path)
            assert not bool(z["torch_loaded"]), "a client imported torch"
            assert not bool(z["jax_loaded"])
            for i in range(12):
                want = model_engine.predict(z[f"ids{i}"], z[f"vals{i}"],
                                            timeout=60)
                np.testing.assert_array_equal(z[f"probs{i}"], want)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        srv.stop()
        srv.close()


def test_spawned_client_main_exits_zero(model_engine):
    srv = port_serve.FrontendServer(model_engine, 2, field_size=F,
                                    slab_records=8)
    t = _serve_bg(srv)
    procs = [srv.spawn_client(c, 10, 8, V, 900 + c) for c in range(2)]
    try:
        for p in procs:
            p.join(timeout=120)
        assert [p.exitcode for p in procs] == [0, 0]
        t.join(timeout=30)
        assert not t.is_alive()
        assert srv.responses_sent == 20 and srv.errors_sent == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        srv.stop()
        srv.close()


def test_killed_spawned_client_is_retired(client_module, model_engine):
    """A client process killed without a farewell: its response ring backs
    up, the liveness probe (its process) says gone, the server drops its
    responses and exits once the other client said bye."""
    srv = port_serve.FrontendServer(model_engine, 2, field_size=F,
                                    slab_records=8, capacity=2)
    procs = {}
    srv._client_alive = lambda cid: procs[cid].is_alive()
    procs[0] = srv.spawn_client(0, target=client_module.hang)
    t = _serve_bg(srv)
    try:
        deadline = time.monotonic() + 60
        while srv.responses_sent < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        procs[0].kill()
        procs[0].join(timeout=30)
        procs[1] = srv.spawn_client(1, 3, 4, V, 7)
        procs[1].join(timeout=120)
        assert procs[1].exitcode == 0
        t.join(timeout=30)
        assert not t.is_alive()
        assert srv.dropped_dead_client >= 1
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
        srv.stop()
        srv.close()


def test_spawned_client_gets_typed_overload_and_timeout(tmp_path,
                                                        client_module):
    """Over the process boundary: a request over the queue bound comes
    back as ``ServerOverloaded``, one never flushed as ``ServeTimeout``
    after the per-request budget."""
    eng = port_serve.ServingEngine(base_predict, max_batch=2, queue_rows=2,
                                   start=False)
    srv = port_serve.FrontendServer(eng, 1, field_size=FIELD_SIZE,
                                    request_timeout_s=0.3)
    t = _serve_bg(srv)
    out = str(tmp_path / "names.npy")
    p = srv.spawn_client(0, out, target=client_module.typed_errors)
    try:
        p.join(timeout=120)
        assert p.exitcode == 0
        t.join(timeout=30)
        assert not t.is_alive()
        assert np.load(out).tolist() == ["ServerOverloaded", "ServeTimeout"]
        assert srv.errors_sent == 2 and srv.timeouts_sent == 1
    finally:
        if p.is_alive():
            p.kill()
        srv.stop()
        srv.close()
        eng.start()
        eng.close(timeout=5)


def test_wedged_predict_behind_a_spawned_client_calls_abort(client_module):
    """A predict that never returns stops the watchdog's beats: the
    injected ``abort`` is called (``serving-frontend`` in its dump), as the
    exit-43 contract would call ``os._exit``."""
    release = threading.Event()

    def wedged(ids, vals):
        release.wait(60)
        return base_predict(ids, vals)

    eng = port_serve.ServingEngine(wedged, max_batch=4, max_delay_ms=1)
    fired = []
    srv = port_serve.FrontendServer(
        eng, 1, field_size=FIELD_SIZE, timeout_s=0.5,
        abort=lambda dump: (fired.append(dump), srv.stop()))
    t = _serve_bg(srv)
    p = srv.spawn_client(0, target=client_module.hang)
    try:
        t.join(timeout=60)
        assert not t.is_alive(), "the watchdog never fired"
        assert len(fired) == 1 and "serving-frontend" in fired[0]
    finally:
        release.set()
        p.kill()
        p.join(timeout=30)
        srv.stop()
        srv.close()
        eng.close(timeout=5)


def test_client_import_chain_leaves_torch_out():
    """Importing the frontend (what a spawned client imports) loads no
    torch; the watchdog's module does, so it is imported only by serve."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, deepfm_tpu_torch.serve.frontend; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] == "
         "'torch'))"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
    assert "StallWatchdog" not in vars(frontend)
