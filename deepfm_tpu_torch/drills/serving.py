"""Serving drill: a replicated serving fleet hot-swapping against a live
publisher (the port's copy of the JAX repo's ``scripts/serving_drill.py``).

  1. **Live publisher.** Real train steps run in this process and publish a
     servable artifact through the port's ``Publisher`` every few steps
     (staging dir, atomic rename, ``LATEST`` pointer): at least 3 versions.
  2. **Concurrent serving under load.** A replicated fleet (default 2
     pipelined engines with a small-request priority lane, sticky client
     affinity, staggered swaps; ``--replicas 1`` is a single engine) over
     the publish dir serves closed-loop client threads the whole time.
     Every replica must hot-swap through >= 2 versions beyond the initial
     load with zero dropped or failed requests and zero failed swaps, every
     returned prob finite and in [0, 1]. With ``--frontend_clients N``, N
     spawned client processes then send requests through a
     :class:`~deepfm_tpu_torch.serve.frontend.FrontendServer` over the same
     fleet: every one answered, every client exiting 0.
  3. **Blackout per replica.** Each replica's watcher pre-warms every
     serving bucket before its swap, and the coordinator staggers the
     fleet, so the swap-to-first-new-version-flush blackout must stay
     under ``MAX_BLACKOUT_MS`` on every replica, with ``prewarmed_buckets``
     > 0.
  4. **Bucket parity.** The final artifact loaded raw and bucket-padded on
     the same device: the padded outputs must equal the unpadded call bit
     for bit, row for row, across non-bucket batch sizes.
  5. **Report.** p50/p99 latency, QPS, batch occupancy and each replica's
     blackout, written where ``--report`` points (nowhere by default).

The model's width is a parameter: :data:`TINY_MODEL` is the JAX drill's
(``python -m deepfm_tpu_torch.drills.serving --device cpu`` runs it on the
CPU); ``--width reference`` serves ``Config()``'s reference width.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import Config
from ..serve import FrontendServer, ReplicatedEngine, ServingEngine
from ..utils import device as device_lib

#: The JAX drill's model (its ``FEATURE_SIZE``, ``FIELD_SIZE`` and
#: ``_tiny_cfg``).
TINY_MODEL = dict(feature_size=120, field_size=5, embedding_size=4,
                  deep_layers="8", dropout="1.0", compute_dtype="float32")
TRAIN_STEPS = 16
PUBLISH_EVERY = 4        # versions at steps 4, 8, 12, 16
N_CLIENTS = 3
MAX_REQ_ROWS = 24
REPLICAS = 2             # the fleet under test (1 = a single engine)
INFLIGHT = 2             # pipelined batching depth per replica
SMALL_ROWS = 4           # priority-lane threshold (exercised under swaps)
MIN_SWAPS = 3            # initial load + >= 2 hot swaps, PER replica
MIN_REQUESTS = 200
# Worst-case swap-to-next-flush gap with bucket pre-warm: with every bucket
# warmed off-thread before the swap, what remains is scheduling noise.
MAX_BLACKOUT_MS = 100.0
FRONTEND_REQUESTS = 60   # requests per spawned frontend client


def model_of(cfg: Config) -> Dict[str, Any]:
    """The fields of ``cfg`` that a drill's ``model`` sets (those of
    :data:`TINY_MODEL`)."""
    return {k: getattr(cfg, k) for k in sorted(TINY_MODEL)}


def reference_model() -> Dict[str, Any]:
    """``Config()``'s model: the reference width and its default dtype and
    dropout."""
    return model_of(Config())


def _say_factory(verbose: bool):
    return ((lambda msg: print(f"[serving_drill] {msg}", flush=True))
            if verbose else (lambda msg: None))


def drill_cfg(model: Dict[str, Any]) -> Config:
    return Config(batch_size=32, mesh_data=1, log_steps=0, seed=29,
                  scale_lr_by_world=False, serve_max_batch=64,
                  serve_max_delay_ms=3.0, **model)


def _train_batch(cfg: Config, rng) -> Dict[str, np.ndarray]:
    return {
        "label": (rng.random((cfg.batch_size, 1)) < 0.25).astype(np.float32),
        "feat_ids": rng.integers(0, cfg.feature_size,
                                 (cfg.batch_size, cfg.field_size)
                                 ).astype(np.int32),
        "feat_vals": rng.normal(size=(cfg.batch_size, cfg.field_size)
                                ).astype(np.float32),
    }


def _publish_while_training(cfg: Config, publish_dir: str, swap_seen,
                            device, say) -> List[int]:
    """The live side: real train steps, the real Publisher, >= 3 versions.
    Between versions the loop waits until the serving side swapped to the
    previous one: the drill must observe every hot swap, not only the last
    (a fast publisher would collapse them into one)."""
    from ..train import Trainer
    from ..train.publish import Publisher

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    rng = np.random.default_rng(5)
    pub = Publisher(cfg, publish_dir, every_steps=PUBLISH_EVERY)
    versions = []
    try:
        for step in range(1, TRAIN_STEPS + 1):
            state, _ = trainer.train_step(
                state, trainer.put_batch(_train_batch(cfg, rng)))
            if step % PUBLISH_EVERY == 0:
                pub.publish_now(state, step)
                assert pub.drain(timeout=120), f"publish {step} wedged"
                versions.append(step)
                say(f"published version {step}")
                deadline = time.monotonic() + 60
                while (swap_seen() < len(versions)
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
    finally:
        pub.close()
    return versions


def _client_loop(engine, cfg: Config, seed: int, stop, counts, failures):
    rng = np.random.default_rng(seed)
    # A replicated fleet routes sticky by client id: each drill client
    # keeps its seed as the affinity key, so every replica sees sustained
    # traffic (the per-replica blackout gate needs post-swap flushes on
    # every replica).
    kw = ({"affinity": seed}
          if getattr(engine, "supports_affinity", False) else {})
    while not stop.is_set():
        n = int(rng.integers(1, MAX_REQ_ROWS + 1))
        ids = rng.integers(0, cfg.feature_size,
                           (n, cfg.field_size)).astype(np.int32)
        vals = rng.normal(size=(n, cfg.field_size)).astype(np.float32)
        try:
            probs = engine.predict(ids, vals, timeout=60, **kw)
        except Exception as e:  # noqa: BLE001 — the drill's core assertion
            failures.append(repr(e))
            continue
        if (probs.shape != (n,) or not np.all(np.isfinite(probs))
                or not np.all((probs >= 0) & (probs <= 1))):
            failures.append(f"bad probs: shape={probs.shape}")
        counts[0] += 1


def assert_bucket_parity(artifact_dir: str, cfg: Config, device,
                         say=lambda msg: None) -> Dict[str, int]:
    """Padded-bucket outputs bit-equal to the unpadded call, row for row,
    on ``device``; returns the bucketed loader's calls per bucket."""
    from ..utils import export as export_lib

    raw = export_lib.load_serving(artifact_dir, device=device)
    bucketed = export_lib.load_serving(artifact_dir, buckets=(4, 16, 64),
                                       device=device)
    rng = np.random.default_rng(11)
    for n in (1, 3, 5, 16, 23, 64):
        ids = rng.integers(0, cfg.feature_size,
                           (n, cfg.field_size)).astype(np.int32)
        vals = rng.normal(size=(n, cfg.field_size)).astype(np.float32)
        np.testing.assert_array_equal(
            bucketed(ids, vals), np.asarray(raw(ids, vals)),
            err_msg=f"bucket parity broke at n={n}")
    calls = dict(bucketed.calls_per_bucket)
    say(f"bucket parity ok (calls_per_bucket={calls})")
    return calls


def run_frontend(engine, cfg: Config, n: int, requests: int
                 ) -> Dict[str, Any]:
    """``n`` spawned client processes (``client_main``, ``requests`` each)
    behind one :class:`FrontendServer` over ``engine``, served on a
    thread; returns the server's counts, the clients' exit codes, the
    seconds from the start to the first request read (``spawn_s``: the
    clients' process start), the seconds from the first request read to
    the last response sent (``serving_s``) and the requests per second
    over that window."""
    server = FrontendServer(engine, n, field_size=cfg.field_size,
                            slab_records=MAX_REQ_ROWS)
    error: List[BaseException] = []

    def serve():
        try:
            server.serve()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            error.append(e)

    thread = threading.Thread(target=serve, name="frontend-serve",
                              daemon=True)
    procs = []
    t0 = time.perf_counter()
    thread.start()
    try:
        procs = [server.spawn_client(c, requests, MAX_REQ_ROWS,
                                     cfg.feature_size, 1000 + c)
                 for c in range(n)]
        deadline = time.monotonic() + 300
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        thread.join(timeout=max(1.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
        if error:
            raise error[0]
        assert not thread.is_alive(), "frontend never drained"
        assert server.last_response_t is not None, "no response was sent"
        serving_s = server.last_response_t - server.first_request_t
        return {"clients": n, "exit_codes": [p.exitcode for p in procs],
                "responses": server.responses_sent,
                "errors": server.errors_sent,
                "timeouts": server.timeouts_sent,
                "dropped_dead_client": server.dropped_dead_client,
                "wall_s": wall,
                "spawn_s": server.first_request_t - t0,
                "serving_s": serving_s,
                "requests_per_s": server.responses_sent / serving_s}
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        server.stop()
        thread.join(timeout=10)
        server.close()


def run_drill(workdir: Optional[str] = None,
              report_path: Optional[str] = None, verbose: bool = True, *,
              replicas: int = REPLICAS, inflight: int = INFLIGHT,
              small_rows: int = SMALL_ROWS, frontend_clients: int = 0,
              model: Optional[Dict[str, Any]] = None,
              device="cuda") -> Dict[str, Any]:
    """The whole drill; returns the report dict (written to
    ``report_path`` when one is given). With ``frontend_clients``, the
    spawned clients run after the closed-loop phase, over the same
    fleet."""
    say = _say_factory(verbose)
    dev = device_lib.resolve(device)
    t_start = time.time()
    cfg = drill_cfg(dict(TINY_MODEL if model is None else model))
    workdir = workdir or tempfile.mkdtemp(prefix="serving_drill_")
    publish_dir = f"{workdir}/publish"
    say(f"workdir {workdir} replicas={replicas} inflight={inflight} "
        f"small_rows={small_rows} frontend_clients={frontend_clients} "
        f"device={dev}")

    # Serving side first: it must come up BEFORE any artifact exists and
    # start serving the moment version 1 lands.
    engine_kw = dict(
        poll_secs=0.05, max_batch=cfg.serve_max_batch,
        max_delay_ms=cfg.serve_max_delay_ms, inflight=inflight,
        small_rows=small_rows, device=dev)
    if replicas > 1:
        engine = ReplicatedEngine.serve_latest(
            publish_dir, replicas=replicas, **engine_kw)
        watchers = [e.watcher for e in engine.engines]
    else:
        engine = ServingEngine.serve_latest(publish_dir, **engine_kw)
        watchers = [engine.watcher]
    # The publisher's between-version wait counts the SLOWEST replica:
    # every replica must observe every version.
    fleet_swaps = lambda: min(w.swap_count for w in watchers)  # noqa: E731
    stop = threading.Event()
    counts = [0]
    failures: List[str] = []
    clients = [threading.Thread(target=_client_loop,
                                args=(engine, cfg, 100 + i, stop, counts,
                                      failures))
               for i in range(N_CLIENTS)]
    versions: List[int] = []
    pub_error: List[BaseException] = []

    def publisher_thread():
        try:
            versions.extend(_publish_while_training(
                cfg, publish_dir, fleet_swaps, dev, say))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            pub_error.append(e)

    front = None
    try:
        pub_t = threading.Thread(target=publisher_thread)
        pub_t.start()
        # Clients start once version 1 is visible on EVERY replica (before
        # that, predict fails by design: there is nothing to serve) and
        # then run across every later hot swap, the part under test.
        deadline = time.monotonic() + 120
        while (fleet_swaps() < 1 and time.monotonic() < deadline
               and pub_t.is_alive()):
            time.sleep(0.02)
        if pub_error:
            raise pub_error[0]
        assert fleet_swaps() >= 1, "first artifact never appeared fleet-wide"
        say(f"first artifact live ({watchers[0].current_path}); "
            "starting clients")
        for c in clients:
            c.start()
        try:
            pub_t.join(timeout=300)
            assert not pub_t.is_alive(), "publisher wedged"
            if pub_error:
                raise pub_error[0]
            deadline = time.monotonic() + 60
            while counts[0] < MIN_REQUESTS and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            stop.set()
            for c in clients:
                c.join(timeout=60)
        assert len(versions) >= MIN_SWAPS, versions

        if replicas > 1:
            summary = engine.summary()
            blackouts = summary["swap_blackout_ms_per_replica"]
        else:
            summary = engine.stats.summary()
            blackouts = [summary["swap_blackout_ms"]]
        swaps = fleet_swaps()
        swap_failures = sum(w.swap_failures for w in watchers)
        prewarmed = sum(w.prewarmed_buckets for w in watchers)
        final_artifact = watchers[0].current_path
        if frontend_clients > 0:
            front = run_frontend(engine, cfg, frontend_clients,
                                 FRONTEND_REQUESTS)
    finally:
        stop.set()
        engine.close()

    say(f"requests={counts[0]} failures={len(failures)} swaps={swaps} "
        f"(failures={swap_failures}) summary={json.dumps(summary)}")

    # ---- acceptance ----
    assert not failures, failures[:5]
    assert summary["serving_failed"] == 0, summary
    assert summary["serving_overloads"] == 0, summary
    assert swaps >= MIN_SWAPS, \
        f"only {swaps} fleet-wide swaps (need >= {MIN_SWAPS} per replica)"
    assert swap_failures == 0, f"{swap_failures} failed swaps"
    assert counts[0] >= MIN_REQUESTS, f"only {counts[0]} requests completed"
    assert summary["batch_occupancy_pct"] is not None \
        and summary["batch_occupancy_pct"] > 0, summary
    assert summary["serving_p50_ms"] is not None \
        and summary["serving_p99_ms"] is not None, summary
    assert prewarmed > 0, "no watcher ever pre-warmed a bucket"
    for i, b in enumerate(blackouts):
        assert b is not None and b < MAX_BLACKOUT_MS, \
            f"replica {i} swap blackout {b}ms >= {MAX_BLACKOUT_MS}ms " \
            f"(per-replica: {blackouts})"
    if front is not None:
        assert front["exit_codes"] == [0] * frontend_clients, front
        assert front["responses"] == frontend_clients * FRONTEND_REQUESTS \
            and front["errors"] == 0 and front["timeouts"] == 0 \
            and front["dropped_dead_client"] == 0, front
    parity_calls = assert_bucket_parity(final_artifact, cfg, dev, say)

    report = {
        "drill": "serving",
        "ok": True,
        "replicas": replicas,
        "serve_inflight": inflight,
        "serve_small_rows": small_rows,
        "serving_p50_ms": summary["serving_p50_ms"],
        "serving_p99_ms": summary["serving_p99_ms"],
        "serving_small_p99_ms": summary["serving_small_p99_ms"],
        "serving_large_p99_ms": summary["serving_large_p99_ms"],
        "serving_qps": summary["serving_qps"],
        "batch_occupancy_pct": summary["batch_occupancy_pct"],
        "swap_blackout_ms": summary["swap_blackout_ms"],
        "swap_blackout_ms_per_replica": blackouts,
        "serving_requests": summary["serving_requests"],
        "serving_failed": summary["serving_failed"],
        "serving_overloads": summary["serving_overloads"],
        "hot_swaps": swaps,
        "swap_failures": swap_failures,
        "prewarmed_buckets": prewarmed,
        "versions_published": versions,
        "clients": N_CLIENTS,
        "frontend": front,
        "bucket_parity_calls": parity_calls,
        "model": model_of(cfg),
        "device": str(dev),
        "load_kind": "synthetic-closed-loop",
        "elapsed_s": round(time.time() - t_start, 1),
    }
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        say(f"PASS -> {report_path}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default="",
                    help="write the report here (default: none)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--replicas", type=int, default=REPLICAS,
                    help="fleet size (1 = a single engine)")
    ap.add_argument("--inflight", type=int, default=INFLIGHT,
                    help="pipelined batching depth per replica")
    ap.add_argument("--small_rows", type=int, default=SMALL_ROWS,
                    help="priority-lane row threshold (0 disables)")
    ap.add_argument("--frontend_clients", type=int, default=0,
                    help="spawned client processes behind a FrontendServer "
                         "over the same fleet (default 0)")
    ap.add_argument("--width", choices=("tiny", "reference"), default="tiny",
                    help="the JAX drill's model, or Config()'s reference "
                         "width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_drill(args.workdir, args.report or None, replicas=args.replicas,
              inflight=args.inflight, small_rows=args.small_rows,
              frontend_clients=args.frontend_clients,
              model=(reference_model() if args.width == "reference"
                     else TINY_MODEL),
              device=args.device)
    print("[serving_drill] PASS", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
