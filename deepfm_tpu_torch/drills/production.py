"""Production-day drill: a chaos-scheduled serve -> log -> train -> publish
loop (the port's copy of the JAX repo's ``scripts/production_drill.py``).

The whole online system exercised as one closed loop:

  1. **Serve.** A seeded diurnal traffic plan (``loop/traffic.py``) drives
     ``ServingEngine.serve_latest`` over the publish dir, starting from a
     bootstrap version-0 artifact (also the frozen baseline model of the
     windowed-AUC comparison).
  2. **Log.** Every served request is written back as impression shards
     (``loop/impressions.py``), bit-identical to what the engine scored.
  3. **Join.** Labels arrive on a seeded delay distribution; the
     delayed-label joiner (``loop/join.py``) emits training shards into the
     live stream directory, exactly once and in admission order.
  4. **Train + publish.** The online trainer tails those shards and
     hot-publishes through the ``Publisher``; the engine hot-swaps every
     version with zero dropped requests. The full mode runs ``python -m
     deepfm_tpu_torch.launch --online_mode 1`` under
     :func:`~deepfm_tpu_torch.drills.supervise.run_supervised`; the smoke
     runs an in-process trainer thread.
  5. **Chaos.** One seeded
     :class:`~deepfm_tpu_torch.utils.faults.ChaosSchedule` arms read faults inside the trainer's stream, one publish crash (the
     previous artifact stays live) and, in the full mode, one SIGTERM with
     a supervised resume. Same seed and schedule: the same chaos, traffic
     and labels.

Gates:
  * zero dropped/failed/overloaded requests across >= 3 hot swaps;
  * every audited record bit-identical between the serving feature path
    and the training decoder;
  * staleness (impression -> first servable model trained on it) p95
    reported and, in the full mode, bounded by join window + label delay +
    observed publish cadence;
  * final params finite, publish versions monotonic, ``LATEST`` = max;
  * the joiner's audit (counters and joined labels) equal to a pure
    simulation from the seeds alone.

Also here: the overload drill (the admission ladder of a cascade under a
slow executor), the cache drill (the result cache on and off, bit-equal
answers) and the experiment drill (shadow, canary, promotion, and three
poisoned challengers rolled back and quarantined).

The model's width is a parameter: :data:`TINY_MODEL` is the JAX drill's,
which the CPU tests pass; the card's smoke passes ``Config()``'s reference
width. The drills run on the card unless given ``device="cpu"``; a report
is written only where ``--report`` points.

    python -m deepfm_tpu_torch.drills.production [--smoke] [--device cpu]
        [--width tiny|reference] [--report PATH]
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import signal
import subprocess
import tempfile
import threading
import time

import numpy as np

from ..config import Config
from ..loop import (DelayedLabelJoiner, DiurnalTrafficPlan, ImpressionLogger,
                    LoopHealth, SeededLabelFeed, SkewChecker,
                    staleness_summary, windowed_auc)
from ..obs import trace as trace_lib
from ..serve import ServingEngine
from ..utils import device as device_lib
from ..utils import export as export_lib
from ..utils import faults as faults_lib
from .serving import model_of, reference_model
from .supervise import (REPO_ROOT, child_env, launcher_cmd,
                        run_supervised)

#: The JAX drill's model (its ``FEATURE_SIZE``, ``FIELD_SIZE`` and
#: ``_flags``).
TINY_MODEL = dict(feature_size=64, field_size=5, embedding_size=4,
                  deep_layers="8", dropout="1.0", compute_dtype="float32")
BATCH_SIZE = 16
SHARD_RECORDS = 32       # impression rows per logged shard

# Full drill (subprocess trainer).
FULL = dict(duration_s=24.0, base_qps=6.0, peak_qps=22.0, max_rows=6,
            publish_every=6, join_window_s=4.0, delay_s=(0.5, 6.0),
            read_fault_every=11, idle_timeout_s=10.0, auc_windows=4)
# In-process smoke: the same loop, a trainer thread, pace-compressed.
SMOKE = dict(duration_s=8.0, base_qps=8.0, peak_qps=30.0, max_rows=4,
             publish_every=4, join_window_s=3.0, delay_s=(0.3, 4.5),
             read_fault_every=0, idle_timeout_s=0.0, auc_windows=3)

MIN_HOT_SWAPS = 3

# Overload drill (degradation ladder under executor_slow chaos): the flood
# is sized so the ranking engine saturates only while the injected slow
# window is live; the window counts flushes, not seconds, so the recovery
# half cannot be starved by a slow host.
OVERLOAD = dict(duration_s=3.0, offered_qps=110.0, users=1_000_000,
                hist_len=6, retrieve_k=12, degrade_retrieve_k=4,
                max_batch=16, queue_rows=96, shed_watermark=32,
                slo_ms=250.0, workers=12, slow_ms=45.0, slow_calls=30,
                timeout_s=12.0)

# Experiment drill (gated deployment): windows sized so every health
# window clears min_samples at the default seed. The latency guardrail is
# the absolute p99 ceiling (the ratio gate is parked at 1e6): the degraded
# challenger's injected sleep exceeds it by construction. AUC and
# calibration tolerances are lenient: each arm sees a few dozen synthetic
# rows per window.
EXPERIMENT = dict(duration_s=12.0, base_qps=20.0, peak_qps=20.0,
                  max_rows=4, window_requests=18, permille=600,
                  min_samples=8, min_auc_delta=-0.35,
                  max_p99_ratio=1e6, max_p99_ms=150.0,
                  max_calibration_err=0.75, max_candidate_age_s=120.0,
                  windows_required=2, shadow_slo_ms=60.0,
                  slow_ms=250.0, stale_age_s=600.0,
                  train_steps=4, nan_train_batches=20,
                  serve_max_batch=16, serve_max_delay_ms=1.0)
# Smoke overrides: fewer requests per window, a shorter injected sleep.
EXPERIMENT_SMOKE = dict(duration_s=8.0, window_requests=8, min_samples=4,
                        train_steps=3, slow_ms=200.0)
# Overrides at a model wider than the JAX drill's (Config()'s 117,581 ids):
# a plan row's ids are drawn uniformly, so almost none recurs in another
# row, and a candidate ranks a window's rows only once it has trained on
# each of them. Four steps of 16 rows leave it at chance, where windows of
# ~20 rows an arm can put a healthy challenger min_auc_delta below the
# control. 160 steps pass over every plan row about four times.
EXPERIMENT_WIDE = dict(train_steps=160, nan_train_batches=160)

#: Shadow-lane impressions log the same served row under the challenger
#: arm; offsetting the impression id keeps the log's ids unique while the
#: original id (and its label) stays recoverable by modulus.
SHADOW_IID_OFFSET = 1 << 20

# Cache bit-identity drill: small, since the claim is correctness.
CACHE_DRILL = dict(duration_s=1.2, offered_qps=120.0, users=4_000,
                   hist_len=6, retrieve_k=8, max_batch=16,
                   queue_rows=4096, repeat_p=0.5, cache_rows=2048,
                   user_cache_rows=512, k=5, timeout_s=30.0)

def _say_factory(verbose):
    return (lambda msg: print(f"[production_drill] {msg}", flush=True)) \
        if verbose else (lambda msg: None)


def _device_kind(dev) -> str:
    import torch
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def _flags(data_dir, model_dir, publish_every, idle_timeout_s,
           trace="off", trace_dir="", model=None):
    flags = dict(
        task_type="train", data_dir=data_dir, model_dir=model_dir,
        **(TINY_MODEL if model is None else model),
        batch_size=BATCH_SIZE, num_epochs=1, mesh_data=1, log_steps=0,
        scale_lr_by_world=False, seed=17, verify_crc=True,
        save_checkpoints_steps=0, io_retry_backoff_secs=0.0,
        pipe_mode=1, online_mode=1, steps_per_loop=1,
        publish_every_steps=publish_every,
        stream_poll_secs=0.1, stream_idle_timeout_secs=idle_timeout_s,
        serve_max_batch=64, serve_max_delay_ms=3.0)
    if trace != "off":
        # The trainer (a subprocess in the full drill) writes its own
        # trace-<pid>.json next to the drill's; merge() stitches them.
        flags.update(trace=trace, trace_dir=trace_dir)
    return flags


class _LogicalClock:
    """Wall time -> drill-logical time: ``pace`` wall seconds per logical
    second. Every join/label/chaos decision is made in logical time, so
    the smoke (pace << 1) and the full drill replay the same decisions."""

    def __init__(self, pace):
        self.pace = float(pace)
        self._t0 = time.monotonic()

    def now(self):
        return (time.monotonic() - self._t0) / self.pace


def _bootstrap_v0(cfg, publish_dir, say, device):
    """Publish the version-0 artifact the engine serves before the trainer
    has produced anything; its params are the frozen AUC baseline."""
    from ..train import Trainer
    from ..train.publish import Publisher

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    pub = Publisher(cfg, publish_dir)
    pub.publish_now(state, 0)
    pub.close()
    path = os.path.join(publish_dir, "0")
    assert os.path.exists(os.path.join(path, export_lib.COMPLETE_MARKER)), \
        "bootstrap publish did not complete"
    say(f"bootstrap artifact v0 live at {path}")
    return export_lib.load_serving(path, device=device)


def _expected_join(plan, feed, join_window_s):
    """Pure logical simulation of every join decision from the seeds alone:
    what the live joiner must reproduce exactly."""
    counters = {"labels_joined": 0, "impressions_expired": 0,
                "labels_past_window": 0}
    labels = {}
    for req in plan.requests:
        for k in range(int(req.ids.shape[0])):
            iid = req.first_id + k
            if feed.delay_for(iid) <= join_window_s:
                counters["labels_joined"] += 1
                labels[iid] = float(req.labels[k])
            else:
                counters["impressions_expired"] += 1
                counters["labels_past_window"] += 1
                labels[iid] = DelayedLabelJoiner.DEFAULT_LABEL
    return counters, labels


def _emitted_labels(out_dir):
    """iid -> label actually emitted, read back from the manifest sidecars."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if not (name.startswith(".") and name.endswith(".manifest.json")):
            continue
        with open(os.path.join(out_dir, name), encoding="utf-8") as f:
            m = json.load(f)
        out.update({int(i): float(y)
                    for i, y in zip(m["impressions"], m["labels"])})
    return out


def _audit_artifacts(publish_dir, say, field_size, device):
    """Every artifact loads and serves finite probs, marker step == dir
    version, publish order monotonic, LATEST == max. Dot-prefixed staging
    leftovers are counted, not fatal: a leaked ``.staging-*`` dir is the
    expected evidence of the scheduled publish crash (it fires after the
    staging dir is complete, before the rename)."""
    versions, staging = {}, []
    for name in os.listdir(publish_dir):
        path = os.path.join(publish_dir, name)
        if not os.path.isdir(path):
            continue
        if name.startswith("."):
            staging.append(name)
            continue
        versions[int(name)] = path
    assert versions, f"no artifacts under {publish_dir}"
    for step, path in sorted(versions.items()):
        serve = export_lib.load_serving(path, device=device)
        probs = serve(np.zeros((2, field_size), np.int32),
                      np.ones((2, field_size), np.float32))
        assert probs.shape[0] == 2 and np.all(np.isfinite(probs)), (
            f"artifact {path} served non-finite output")
        with open(os.path.join(path, export_lib.COMPLETE_MARKER)) as f:
            assert json.load(f)["step"] == step, (
                f"artifact {path} marker step != dir version")
    order = [s for s, _ in sorted(versions.items(),
                                  key=lambda kv: os.path.getmtime(kv[1]))]
    assert order == sorted(order), (
        f"versions not monotonic in publish order: {order}")
    latest = export_lib.read_latest(publish_dir)
    assert latest is not None and int(os.path.basename(latest)) == max(
        versions), f"LATEST resolves to {latest}, newest is {max(versions)}"
    say(f"artifact audit: {len(versions)} version(s) "
        f"{sorted(versions)}, {len(staging)} staging leak(s), "
        f"LATEST={max(versions)}")
    return versions, staging


def _final_params_finite(publish_dir):
    import torch
    latest = export_lib.read_latest(publish_dir)
    model, _, _ = export_lib.load_model(latest, device="cpu")
    return all(bool(torch.isfinite(t).all())
               for t in model.state_dict().values()
               if t.is_floating_point())


def _staleness_samples(joiner, served_wall, swap_log):
    """Per-impression end-to-end staleness: serve completion -> the wall
    moment the first model version whose training covered that impression
    became servable (watcher swap observed). Rows past the last published
    training step are 'uncovered' (awaiting the next cadence): counted,
    excluded from the percentile, reported."""
    observed = sorted((v, w) for v, w, _ in swap_log if v > 0)
    samples, uncovered = [], 0
    cum = 0
    for path, iids in sorted(joiner.manifests.items()):
        cum += len(iids)
        version = next((v for v, _ in observed
                        if v * BATCH_SIZE >= cum), None)
        if version is None:
            uncovered += len(iids)
            continue
        wall = dict(observed)[version]
        samples.extend(wall - served_wall[i] for i in iids)
    return samples, uncovered


def _audit_fingerprint(schedule, plan, counters, labels):
    h = hashlib.sha256()
    h.update(schedule.to_json().encode())
    for r in plan.requests:
        h.update(np.float64(r.t_s).tobytes())
        h.update(np.int64(r.first_id).tobytes())
        h.update(r.labels.tobytes())
    h.update(json.dumps(sorted(counters.items())).encode())
    h.update(json.dumps(sorted(labels.items())).encode())
    return h.hexdigest()[:16]


def _mini_trainer(cfg, data_dir, publish_dir, stop_evt, publish_every, out,
                  device):
    """In-process stand-in for the launcher subprocess (the smoke): tail
    emitted tr-shards in sorted order, train real steps through
    ``Trainer.train_step``, publish through the real ``Publisher`` on the
    step cadence, synchronously, so the publish set is exactly {N, 2N, ...}
    and the armed publish crash eats the first attempt."""
    from ..data import example_codec, tfrecord
    from ..train import Trainer
    from ..train.publish import Publisher
    try:
        trainer = Trainer(cfg, device=device)
        state = trainer.init_state()
        pub = Publisher(cfg, publish_dir, every_steps=publish_every)
        consumed = set()
        rows_ids, rows_vals, rows_y = [], [], []
        step = 0
        while True:
            names = [n for n in sorted(os.listdir(data_dir))
                     if n.startswith("tr") and n.endswith(".tfrecords")
                     and n not in consumed]
            if not names:
                if stop_evt.is_set():
                    break
                time.sleep(0.02)
                continue
            for name in names:
                consumed.add(name)
                for rec in tfrecord.iter_records(
                        os.path.join(data_dir, name)):
                    y, ids, vals = example_codec.decode_ctr_example(
                        rec, cfg.field_size)
                    rows_ids.append(ids.astype(np.int32))
                    rows_vals.append(vals)
                    rows_y.append(y)
                while len(rows_y) >= cfg.batch_size:
                    b = cfg.batch_size
                    batch = {
                        "label": np.asarray(
                            rows_y[:b], np.float32).reshape(b, 1),
                        "feat_ids": np.stack(rows_ids[:b]),
                        "feat_vals": np.stack(rows_vals[:b]),
                    }
                    del rows_ids[:b], rows_vals[:b], rows_y[:b]
                    state, _ = trainer.train_step(state,
                                                  trainer.put_batch(batch))
                    step += 1
                    if step % publish_every == 0:
                        pub.publish_now(state, step)
                        pub.drain()
        pub.close()
        out["steps"] = step
        out["publish"] = pub.stats()
        out["leftover_rows"] = len(rows_y)
        out["rc"] = 0
    except BaseException as e:  # noqa: BLE001 — surfaced by the drill
        out["error"] = e
        out["rc"] = 1


def _subprocess_trainer(cmd, env, cell, done_evt, logs, out):
    """The full drill's trainer: the launcher under the supervisor. A clean
    (idle-timeout) exit while the drill is still producing shards
    relaunches, as an online trainer must outlive quiet stretches. Each
    run's result line (the launcher's last stdout line, JSON) is kept."""
    results = out.setdefault("results", [])

    def spawn(c):
        p = subprocess.Popen(c, cwd=REPO_ROOT, env=env,
                             stdout=subprocess.PIPE, text=True)
        cell["proc"] = p
        lines = list(p.stdout)
        rc = p.wait()
        cell["proc"] = None
        for line in reversed(lines):
            if line.startswith("{"):
                results.append(json.loads(line))
                break
        return rc

    rcs = []
    while True:
        rc = run_supervised(cmd, max_restarts=10, backoff_secs=0.0,
                            spawn=spawn, log=logs.append)
        rcs.append(rc)
        if rc != 0 or done_evt.is_set():
            break
        time.sleep(0.3)
    out["rcs"] = rcs
    out["rc"] = rcs[-1]


def _trace_correlation(doc):
    """A ``serve.flush`` event stamped with the artifact step it executed
    (``model_step=N``) whose wall interval overlaps a ``publish.stage``/
    ``publish.rename`` span of a higher version M: the merged timeline
    shows a request served by version N while version M was staging."""
    serves, publishes = [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        t0 = float(ev.get("ts", 0.0))
        t1 = t0 + float(ev.get("dur", 0.0))
        if ev.get("name") == "serve.flush" and "model_step" in args:
            serves.append((t0, t1, int(args["model_step"]), args))
        elif ev.get("name") in ("publish.stage", "publish.rename") \
                and "version" in args:
            publishes.append((t0, t1, int(args["version"]), ev["name"]))
    first = None
    for s0, s1, mstep, sargs in serves:
        for p0, p1, ver, pname in publishes:
            if ver > mstep and p0 < s1 and s0 < p1:
                found = {"serve_model_step": mstep,
                         "publish_version": ver,
                         "publish_span": pname,
                         "sample_trace_ids":
                             list(sargs.get("trace_ids", []))[:4]}
                # Prefer an overlapping flush that carries request trace
                # ids (warmup flushes carry none).
                if found["sample_trace_ids"]:
                    return found
                first = first or found
    return first


def _run_core(workdir, *, mode, seed, pace, say, trace="off", tb_dir="",
              model=None, device="cuda"):
    params = FULL if mode == "full" else SMOKE
    model = dict(TINY_MODEL if model is None else model)
    dev = device_lib.resolve(device)
    field_size = int(model["field_size"])
    t_start = time.time()
    os.makedirs(workdir, exist_ok=True)
    imp_dir = os.path.join(workdir, "impressions")
    data_dir = os.path.join(workdir, "data")
    model_dir = os.path.join(workdir, "ckpt")
    publish_dir = os.path.join(model_dir, "publish")
    trace_dir = os.path.join(workdir, "trace")
    os.makedirs(data_dir, exist_ok=True)
    if trace != "off":
        trace_lib.configure(trace, trace_dir=trace_dir)

    schedule = faults_lib.ChaosSchedule.generate(
        seed, horizon_s=params["duration_s"],
        read_fault_every=params["read_fault_every"],
        publish_crashes=1, publish_crash_stage="before_rename",
        preemptions=1 if mode == "full" else 0)
    say(f"chaos schedule {schedule.fingerprint()}: "
        + ", ".join(f"{e.kind}@{e.at_s:g}s" for e in schedule.events))

    plan = DiurnalTrafficPlan(
        seed, duration_s=params["duration_s"], base_qps=params["base_qps"],
        peak_qps=params["peak_qps"], feature_size=int(model["feature_size"]),
        field_size=field_size, max_rows=params["max_rows"])
    say(f"traffic plan: {len(plan.requests)} requests / "
        f"{plan.total_rows} rows over {params['duration_s']:g} logical s "
        f"(pace {pace:g})")
    delay_lo, delay_hi = params["delay_s"]
    feed = SeededLabelFeed(seed + 1, delay_min_s=delay_lo,
                           delay_max_s=delay_hi)
    health = LoopHealth()
    logger = ImpressionLogger(imp_dir, shard_records=SHARD_RECORDS,
                              health=health)
    joiner = DelayedLabelJoiner(imp_dir, data_dir, feed,
                                join_window_s=params["join_window_s"],
                                health=health)

    flags = _flags(data_dir, model_dir, params["publish_every"],
                   params["idle_timeout_s"], trace, trace_dir, model)
    cfg = Config(**flags)
    baseline_fn = _bootstrap_v0(cfg, publish_dir, say, dev)

    engine = ServingEngine.serve_latest(
        publish_dir, poll_secs=0.05, max_batch=cfg.serve_max_batch,
        max_delay_ms=cfg.serve_max_delay_ms, device=dev)
    watcher = engine.watcher

    # ---- trainer side -------------------------------------------------
    done_evt = threading.Event()
    trainer_out, sup_logs, cell = {}, [], {"proc": None}
    if mode == "full":
        state_file = os.path.join(workdir, "chaos_state.json")
        sched_file = os.path.join(workdir, "chaos_schedule.json")
        with open(sched_file, "w", encoding="utf-8") as f:
            f.write(schedule.to_json())
        env = child_env(**{faults_lib.CHAOS_ENV: "@" + sched_file,
                      faults_lib.CHAOS_STATE_ENV: state_file})
        trainer_thread = threading.Thread(
            target=_subprocess_trainer,
            args=(launcher_cmd(flags, dev), env, cell, done_evt,
                  sup_logs, trainer_out))
    else:
        schedule.install(
            state_path=os.path.join(workdir, "chaos_state.json"))
        trainer_thread = threading.Thread(
            target=_mini_trainer,
            args=(cfg, data_dir, publish_dir, done_evt,
                  params["publish_every"], trainer_out, dev))
    trainer_thread.start()

    # ---- the drill loop ----------------------------------------------
    clock = _LogicalClock(pace)
    served = {}           # iid -> (ids, vals) exactly as scored
    served_wall = {}      # iid -> wall completion time
    samples = []          # (t_s, label, online_prob, baseline_prob)
    failures = []
    swap_log = []         # (version, wall, logical) first-observed
    fired, pending_preempts, preempts_sent = set(), [], []
    seen_path = [None]
    tail_ids = np.zeros((2, field_size), np.int32)
    tail_vals = np.ones((2, field_size), np.float32)
    last_tail = [0.0]
    # Labels stay here until the row's impression shard is sealed on disk:
    # a label polled before its impression is visible to the joiner is an
    # orphan by contract (labels_late). Deferring the push never moves the
    # arrival (served_at + delay_for(iid)), so join decisions stay
    # seed-pure.
    label_backlog = collections.deque()
    logger_closed = [False]

    def flush_labels():
        sealed = (plan.total_rows if logger_closed[0]
                  else SHARD_RECORDS * len(logger.shards))
        while label_backlog and label_backlog[0][0] < sealed:
            iid, y, t = label_backlog.popleft()
            feed.push(iid, y, t)

    def pump(now_l):
        flush_labels()
        for _ in joiner.pump(now_l):
            pass
        cur = watcher.current_path
        if cur != seen_path[0]:
            seen_path[0] = cur
            try:
                v = int(os.path.basename(cur))
            except (TypeError, ValueError):
                v = -1
            swap_log.append((v, time.monotonic(), now_l))
            say(f"hot swap -> v{v} at logical {now_l:.1f}s")
        # Driver-side chaos: SIGTERM fires at its scheduled logical time,
        # once the trainer has published (its preemption listener is
        # certainly installed by then).
        if any(v > 0 for v, _, _ in swap_log):
            pending_preempts.extend(schedule.due(now_l, fired))
        for ev in list(pending_preempts):
            proc = cell.get("proc")
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                pending_preempts.remove(ev)
                preempts_sent.append(round(now_l, 2))
                say(f"chaos: SIGTERM to trainer pid {proc.pid} "
                    f"(scheduled {ev.at_s:g}s, fired {now_l:.1f}s)")

    def tail_request():
        # Keep requests flowing outside the plan (drain + trainer tail) so
        # "zero loss across every hot swap" covers the late swaps too.
        if time.monotonic() - last_tail[0] < 0.08:
            return
        last_tail[0] = time.monotonic()
        try:
            engine.predict(tail_ids, tail_vals, timeout=60,
                           trace_id=(trace_lib.new_trace_id()
                                     if trace != "off" else None))
        except Exception as e:  # noqa: BLE001 — the loss gate
            failures.append(f"tail: {e!r}")

    try:
        for req in plan.requests:
            while clock.now() < req.t_s:
                pump(clock.now())
                time.sleep(min(0.005, max(0.0005, 0.002 * pace)))
            tid = trace_lib.new_trace_id() if trace != "off" else None
            try:
                fut = engine.submit(req.ids, req.vals, trace_id=tid)
                probs = fut.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — the loss gate
                failures.append(f"req@{req.t_s:g}: {e!r}")
                continue
            base = np.asarray(baseline_fn(req.ids, req.vals))
            wall = time.monotonic()
            # Impressions stamp the request's trace_id and the version
            # that scored it: the log side of request->model correlation.
            iids = logger.log_request(req.first_id, req.ids, req.vals,
                                      req.t_s, trace_id=tid,
                                      model_version=fut.model_version)
            for k, iid in enumerate(iids):
                served[iid] = (req.ids[k], req.vals[k])
                served_wall[iid] = wall
                label_backlog.append((iid, float(req.labels[k]), req.t_s))
                samples.append((req.t_s, float(req.labels[k]),
                                float(probs[k]), float(base[k])))
        logger.close()
        logger_closed[0] = True
        say(f"traffic done: {len(served)} rows served+logged, "
            f"{len(failures)} failures so far")

        # Drain: pump until every label has arrived and every window
        # closed, so the final counters are the pure function of the seeds.
        while label_backlog or feed.pending or joiner.open_impressions:
            pump(clock.now())
            tail_request()
            time.sleep(0.002)
        joiner.finalize(clock.now())
        done_evt.set()
        nonzero = {k: v for k, v in health.snapshot().items() if v}
        say(f"label drain complete at logical {clock.now():.1f}s; "
            f"health={json.dumps(nonzero)}")

        while trainer_thread.is_alive():
            pump(clock.now())
            tail_request()
            time.sleep(0.01)
        trainer_thread.join()
        if trainer_out.get("error") is not None:
            raise trainer_out["error"]
        assert trainer_out.get("rc") == 0, (
            f"trainer failed: {trainer_out}; supervisor log tail "
            f"{sup_logs[-3:]}")

        # Final servable state: LATEST must reach the max published
        # version and the watcher must swap to it.
        expected_max = max(int(n) for n in os.listdir(publish_dir)
                           if os.path.isdir(os.path.join(publish_dir, n))
                           and not n.startswith("."))
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            cur = watcher.current_path
            if cur is not None and os.path.basename(cur) == str(
                    expected_max):
                break
            pump(clock.now())
            tail_request()
            time.sleep(0.02)
        pump(clock.now())
        stats = engine.stats.summary()
        swaps = watcher.swap_count
        swap_failures = watcher.swap_failures
        watcher_errors = watcher.watcher_errors
    finally:
        done_evt.set()
        proc = cell.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
        trainer_thread.join(timeout=60)
        engine.close()
        logger.close()
    if tb_dir:
        # Serving-side scalars ride the trainer's writer
        # (obs.tensorboard), stepped at the final published version.
        from ..obs.tensorboard import TensorBoardWriter
        tbw = TensorBoardWriter(tb_dir)
        tbw.scalar_dict(expected_max, "serving/", stats)
        tbw.scalar_dict(expected_max, "loop/", health.snapshot())
        tbw.close()

    # ---- audits --------------------------------------------------------
    counters = health.snapshot()
    expected, expected_labels = _expected_join(
        plan, feed, params["join_window_s"])
    actual_labels = _emitted_labels(data_dir)
    counters_ok = all(counters[k] == v for k, v in expected.items()) \
        and counters["duplicate_impressions"] == 0 \
        and counters["labels_late"] == 0 \
        and counters["torn_impression_shards"] == 0 \
        and counters["records_emitted"] == plan.total_rows
    labels_ok = actual_labels == expected_labels
    assert counters_ok, (
        f"joiner counters diverged from the seed-pure simulation:\n"
        f"  actual   {counters}\n  expected {expected}")
    assert labels_ok, "emitted labels diverged from the simulation"
    say("determinism: counters + emitted labels match the pure logical "
        "simulation (seed-replayable)")

    checker = SkewChecker(served)
    for shard in joiner.emitted_shards:
        checker.audit_shard(shard)
    assert checker.ok, (
        f"training/serving skew: {checker.mismatches[:5]}")
    assert checker.records_audited == plan.total_rows, (
        f"audited {checker.records_audited} of {plan.total_rows} rows")
    say(f"skew check: {checker.records_audited} records bit-identical "
        "across serving path and training decoder")

    versions, staging = _audit_artifacts(publish_dir, say, field_size, dev)
    crashed_version = params["publish_every"]
    crash_fired = crashed_version not in versions and len(staging) >= 1
    finite = _final_params_finite(publish_dir)
    assert finite, "final published params contain non-finite values"

    stale_samples, uncovered = _staleness_samples(
        joiner, served_wall, swap_log)
    stale = staleness_summary(stale_samples)
    pub_walls = sorted(w for v, w, _ in swap_log if v >= 0)
    max_gap = max((b - a for a, b in zip(pub_walls, pub_walls[1:])),
                  default=0.0)
    stale_bound = (params["join_window_s"] + delay_hi) * pace \
        + 2.0 * max_gap + 3.0

    # ---- gates ---------------------------------------------------------
    assert not failures, failures[:5]
    assert stats["serving_failed"] == 0 and stats["serving_overloads"] == 0, \
        stats
    assert swap_failures == 0, f"{swap_failures} failed swaps"
    assert watcher_errors == 0, f"{watcher_errors} watcher errors"
    assert swaps >= MIN_HOT_SWAPS, (
        f"only {swaps} hot swaps (need >= {MIN_HOT_SWAPS})")
    assert crash_fired, (
        f"scheduled publish crash left no evidence: versions "
        f"{sorted(versions)}, staging {staging}")
    if mode == "full":
        assert preempts_sent, "scheduled preemption never fired"
        assert any("restart 1/" in m for m in sup_logs), (
            f"supervisor never restarted after SIGTERM: {sup_logs}")
        assert stale["staleness_p95_s"] is not None \
            and stale["staleness_p95_s"] <= stale_bound, (
            f"staleness p95 {stale['staleness_p95_s']}s exceeds bound "
            f"{stale_bound:.1f}s")

    # ---- merged trace + correlation gate -------------------------------
    trace_section = {"mode": trace}
    if trace != "off":
        trace_lib.export()  # the drill process's own spans
        merged_path = trace_lib.merge(
            trace_dir, os.path.join(trace_dir, "merged_trace.json"))
        with open(merged_path) as f:
            merged = json.load(f)
        correlated = _trace_correlation(merged)
        assert correlated is not None, (
            "merged trace shows no serve-vN flush overlapping a "
            "publish-vM>N staging span")
        trace_section.update(
            merged_path=merged_path,
            merged_from=merged["otherData"]["merged_from"],
            pids=merged["otherData"]["pids"],
            events=len(merged["traceEvents"]),
            dropped_spans=merged["otherData"]["dropped_spans"],
            correlated_serve_publish_overlap=correlated)
        say(f"trace: {len(merged['traceEvents'])} events from "
            f"{merged['otherData']['merged_from']} process(es) -> "
            f"{merged_path}; serve v{correlated['serve_model_step']} "
            f"overlapped publish v{correlated['publish_version']} "
            f"({correlated['publish_span']})")

    report = {
        "drill": "production_day",
        "ok": True,
        "mode": mode,
        "seed": seed,
        "pace": pace,
        "chaos": {
            "fingerprint": schedule.fingerprint(),
            "events": json.loads(schedule.to_json())["events"],
            "publish_crash_fired": crash_fired,
            "preemptions_sent_at_logical_s": preempts_sent,
            "supervised_restarts": sum(
                1 for m in sup_logs if "restart" in m and "/" in m),
        },
        "traffic": {
            "requests": len(plan.requests),
            "rows": plan.total_rows,
            "duration_logical_s": params["duration_s"],
            "base_qps": params["base_qps"],
            "peak_qps": params["peak_qps"],
        },
        "loop_health": {k: v for k, v in counters.items()},
        "determinism": {
            "counters_match_simulation": counters_ok,
            "labels_match_simulation": labels_ok,
            "audit_fingerprint": _audit_fingerprint(
                schedule, plan, counters, actual_labels),
        },
        "skew": {"records_audited": checker.records_audited,
                 "mismatches": len(checker.mismatches)},
        "request_loss": {
            "failed": stats["serving_failed"] + len(failures),
            "overloads": stats["serving_overloads"],
            "hot_swaps": swaps,
            "swap_failures": swap_failures,
            "watcher_errors": watcher_errors,
        },
        "serving": {k: stats[k] for k in (
            "serving_requests", "serving_rows", "serving_p50_ms",
            "serving_p99_ms", "serving_qps", "batch_occupancy_pct",
            "swap_blackout_ms")},
        "staleness": dict(
            stale, covered_rows=len(stale_samples),
            uncovered_rows=uncovered,
            bound_s=round(stale_bound, 1),
            max_publish_gap_s=round(max_gap, 1)),
        "windowed_auc": windowed_auc(samples, params["auc_windows"],
                                     params["duration_s"]),
        "publish": {
            "versions": sorted(versions),
            "crashed_version": crashed_version,
            "staging_leaks": len(staging),
            "final_params_finite": finite,
            # The trainer's publisher: the in-process Publisher's stats
            # (the smoke), or each launcher run's published versions and
            # publish latencies (the full drill).
            "trainer": (trainer_out.get("publish") if mode != "full" else [
                {k: v for k, v in r.items() if k.startswith("publish")}
                for r in trainer_out.get("results", [])]),
        },
        "trace": trace_section,
        "model": model_of(cfg),
        "device_kind": _device_kind(dev),
        "load_kind": "synthetic-diurnal-closed-loop",
        "baseline_kind": "frozen-bootstrap-v0",
        "elapsed_s": round(time.time() - t_start, 1),
    }
    return report


def run_full(workdir, *, seed=2026, pace=1.0, verbose=False, trace="off",
             tb_dir="", model=None, device="cuda"):
    """The full loop alone: the launcher as a supervised subprocess
    trainer, read faults, a publish crash and a SIGTERM with a resume."""
    say = _say_factory(verbose)
    try:
        return _run_core(workdir, mode="full", seed=seed, pace=pace,
                         say=say, trace=trace, tb_dir=tb_dir, model=model,
                         device=device)
    finally:
        if trace != "off":
            trace_lib.reset()  # leak no mode or env into the caller


def run_drill(workdir, *, seed=2026, pace=1.0, report_path=None,
              verbose=True, trace="off", tb_dir="", model=None,
              device="cuda"):
    """The full drill: :func:`run_full`, then the overload and experiment
    drills; writes the report to ``report_path`` when one is given."""
    say = _say_factory(verbose)
    report = run_full(workdir, seed=seed, pace=pace, verbose=verbose,
                      trace=trace, tb_dir=tb_dir, model=model, device=device)
    say("overload drill (degradation ladder under executor_slow)")
    report["overload"] = run_overload_drill(
        os.path.join(workdir, "overload"), seed=seed, verbose=verbose,
        device=device)
    say("experimentation drill (gated deployment: shadow/canary/"
        "promote/rollback)")
    report["experiment"] = run_experiment_drill(
        os.path.join(workdir, "experiment"), seed=seed, verbose=verbose,
        model=model, device=device)
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        say(f"PASS -> {report_path}")
    return report


def run_smoke(workdir, *, seed=11, pace=0.25, verbose=False, trace="off",
              model=None, device="cuda"):
    """In-process smoke: the same loop with the trainer thread (no
    subprocess, no SIGTERM)."""
    say = _say_factory(verbose)
    try:
        return _run_core(workdir, mode="smoke", seed=seed, pace=pace,
                         say=say, trace=trace, model=model, device=device)
    finally:
        faults_lib.set_publish_crash("")  # disarm if the drill died early
        if trace != "off":
            trace_lib.reset()


def build_cascade_artifact(publish_dir, *, seed=3, say=None, device="cuda"):
    """Train and export one small cascade artifact (DIN ranker + twin
    towers + brute index), LATEST -> 1: the overload and cache drills'
    serving substrate."""
    say = say or (lambda msg: None)
    from ..data import libsvm, pipeline as pipeline_lib
    from ..models.twin_tower import train_twin_tower
    from ..rec.cascade import ITEM_SLOT, export_cascade
    from ..rec.index import CandidateIndex
    from ..train import Trainer

    dev = device_lib.resolve(device)
    cfg = Config(**TINY_MODEL, batch_size=32, mesh_data=1, log_steps=0,
                 seed=seed, scale_lr_by_world=False, model="din",
                 history_max_len=OVERLOAD["hist_len"])
    with tempfile.TemporaryDirectory(prefix="overload_data_") as data_dir:
        files = libsvm.generate_synthetic_ctr(
            data_dir, num_files=1, examples_per_file=256,
            feature_size=cfg.feature_size, field_size=cfg.field_size,
            seed=seed, history=cfg.history_max_len)
        batches = list(pipeline_lib.CtrPipeline(
            files, field_size=cfg.field_size, batch_size=cfg.batch_size,
            num_epochs=1, shuffle=False, prefetch_batches=0, history=True,
            history_max_len=cfg.history_max_len))
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    for b in batches:
        state, _ = trainer.train_step(state, trainer.put_batch(b))
    tower, _ = train_twin_tower(cfg, batches, item_slot=ITEM_SLOT,
                                device=dev)
    index = CandidateIndex(tower.all_item_embeddings(cfg.feature_size),
                           kind="brute", device=dev)
    export_cascade(trainer.servable_model(state), cfg,
                   os.path.join(publish_dir, "1"), tower=tower, index=index)
    export_lib.write_latest(publish_dir, "1")
    say(f"cascade artifact v1 live at {publish_dir}")
    return publish_dir


def run_overload_drill(workdir, *, seed=7, verbose=False,
                       publish_dir=None, params=None, device="cuda"):
    """Graceful-degradation drill: flood a ``CascadeEngine`` (admission
    gate + degradation ladder armed) with open-loop Zipf traffic while a
    seeded ``executor_slow`` chaos event throttles the ranking executor,
    then assert the ladder engaged (rung transitions > 0), every request
    got a typed outcome (ok / shed / overload / timeout: no hangs, no
    silent drops), and the ladder recovered (rung 0, empty queue) after the
    slow window drained.

    The audit fingerprint hashes the schedule, the plan, the parameters
    and the asserted outcomes, not timing-dependent counters, so same-seed
    runs on different hosts give the same fingerprint."""
    say = _say_factory(verbose)
    P = dict(OVERLOAD)
    P.update(params or {})
    from ..loop.traffic import FloodTrafficPlan, ZipfUserPopulation
    from ..rec.cascade import CascadeEngine
    from ..serve import AdmissionShed, ServerOverloaded, ServeTimeout
    from ..serve.admission import DEGRADE_RUNGS

    dev = device_lib.resolve(device)
    field_size = TINY_MODEL["field_size"]
    feature_size = TINY_MODEL["feature_size"]
    t_start = time.time()
    try:
        if publish_dir is None:
            publish_dir = build_cascade_artifact(
                os.path.join(workdir, "overload_publish"), say=say,
                device=dev)
        schedule = faults_lib.ChaosSchedule.generate(
            seed, horizon_s=P["duration_s"], executor_slow_events=1,
            executor_slow_ms=P["slow_ms"],
            executor_slow_calls=P["slow_calls"])
        population = ZipfUserPopulation(
            seed, users=P["users"], hist_len=P["hist_len"])
        plan = FloodTrafficPlan(
            seed + 1, offered_qps=P["offered_qps"],
            duration_s=P["duration_s"], population=population,
            field_size=field_size, feature_size=feature_size)
        say(f"chaos {schedule.fingerprint()} "
            f"({len(plan.requests)} requests over {P['duration_s']}s, "
            f"{P['users']} Zipf users)")
        eng = CascadeEngine(
            publish_dir, retrieve_k=P["retrieve_k"],
            max_batch=P["max_batch"], max_delay_ms=2.0,
            queue_rows=P["queue_rows"], slo_ms=P["slo_ms"],
            shed_watermark=P["shed_watermark"],
            degrade_retrieve_k=P["degrade_retrieve_k"],
            watcher_kw={"poll_secs": 3600}, device=dev)
        counters = {"ok": 0, "shed": 0, "overload": 0, "timeout": 0,
                    "failed": 0}
        cnt_lock = threading.Lock()
        idx_lock = threading.Lock()
        next_i = [0]
        t0 = time.monotonic()

        def worker():
            while True:
                with idx_lock:
                    i = next_i[0]
                    if i >= len(plan.requests):
                        return
                    next_i[0] = i + 1
                r = plan.requests[i]
                wait = t0 + r.t_s - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                try:
                    eng.recommend(r.hist_ids, r.hist_mask, r.ids[0],
                                  r.vals[0], k=5, timeout=P["timeout_s"],
                                  value=r.value)
                    outcome = "ok"
                except AdmissionShed:
                    outcome = "shed"
                except ServerOverloaded:
                    outcome = "overload"
                except ServeTimeout:
                    outcome = "timeout"
                except Exception as e:  # noqa: BLE001 — typed into identity
                    say(f"request failed: {e!r}")
                    outcome = "failed"
                with cnt_lock:
                    counters[outcome] += 1

        threads = [threading.Thread(target=worker, name=f"flood-{k}")
                   for k in range(P["workers"])]
        for t in threads:
            t.start()
        fired = set()
        while any(t.is_alive() for t in threads):
            for ev in schedule.due(time.monotonic() - t0, fired):
                if ev.kind == "executor_slow":
                    say(f"chaos: executor_slow {ev.get('delay_ms')}ms x "
                        f"{ev.get('calls')} flushes at t={ev.at_s}s")
                    faults_lib.set_executor_slow(
                        float(ev.get("delay_ms", 0.0)) / 1000.0,
                        int(ev.get("calls", 0)))
            time.sleep(0.01)
        for t in threads:
            t.join()

        # Recovery: let the ladder idle until it releases (the aged delay
        # signal decays; the count-based slow window is exhausted).
        recovery_deadline = time.monotonic() + 10.0
        recovered = False
        while time.monotonic() < recovery_deadline:
            if (eng.ladder_rung() == 0 and eng.engine.pending_rows == 0
                    and faults_lib.executor_slow_remaining() == 0):
                recovered = True
                break
            time.sleep(0.05)
        recovery_s = round(time.monotonic() - t0 - P["duration_s"], 3)
        log = eng.ladder.transition_log
        max_rung = max((new for _, new, _ in log), default=0)
        ladder_engaged = eng.ladder.transitions > 0 and max_rung >= 1
        summary = eng.stats.summary()
        eng.close()
        faults_lib.set_executor_slow(0.0, 0)   # never leak the seam

        total = sum(counters.values())
        accounting_ok = total == len(plan.requests)
        assert accounting_ok, (counters, len(plan.requests))
        assert counters["failed"] == 0, counters
        assert ladder_engaged, (
            f"degradation ladder never engaged: {log}")
        assert recovered, (
            f"ladder did not recover: rung={eng.ladder.rung} "
            f"pending={eng.engine.pending_rows}")
        fingerprint = hashlib.sha256(json.dumps(
            {"schedule": schedule.to_json(),
             "plan": hashlib.sha256(
                 repr(plan.fingerprint_data()).encode()).hexdigest(),
             "params": {k: P[k] for k in sorted(P)},
             "outcomes": {"ladder_engaged": ladder_engaged,
                          "recovered": recovered,
                          "accounting_ok": accounting_ok}},
            sort_keys=True).encode()).hexdigest()[:16]
        say(f"ladder engaged (max rung {max_rung}), recovered in "
            f"{recovery_s}s; counters {counters}")
        return {
            "drill": "overload",
            "seed": seed,
            "params": {k: P[k] for k in sorted(P)},
            "chaos": {"fingerprint": schedule.fingerprint(),
                      "schedule": json.loads(schedule.to_json())},
            "traffic": {"requests": len(plan.requests),
                        "users": population.users,
                        "zipf_q": population.zipf_q,
                        "touched_users": population.touched_users},
            "counters": counters,
            "accounting_ok": accounting_ok,
            "ladder_engaged": ladder_engaged,
            "max_rung": max_rung,
            "rung_names": list(DEGRADE_RUNGS),
            "transition_log": [[prev, new, round(p, 3)]
                               for prev, new, p in log],
            "degrade_transitions": summary["degrade_transitions"],
            "degraded_by_rung": summary["serving_degraded_by_rung"],
            "sheds": summary["serving_sheds"],
            "sheds_by_class": summary["serving_sheds_by_class"],
            "admission_transitions": summary["admission_transitions"],
            "recovered": recovered,
            "recovery_s": recovery_s,
            "audit_fingerprint": fingerprint,
            "device_kind": _device_kind(dev),
            "elapsed_s": round(time.time() - t_start, 1),
        }
    finally:
        faults_lib.set_executor_slow(0.0, 0)


def run_cache_drill(workdir, *, seed=7, verbose=False, publish_dir=None,
                    params=None, device="cuda"):
    """Serving fast-path bit-identity drill: serve one repeat-heavy flood
    plan through the cascade twice over the same artifact (result cache and
    coalescing off, then on) and assert that the on arm took the fast path
    (cache hits > 0 on a plan with repeats) and that the fingerprint over
    every request's full recommendation (ids and probability bytes) is
    identical across arms. Requests are served one after another in plan
    order, so both arms see identical request streams."""
    say = _say_factory(verbose)
    P = dict(CACHE_DRILL)
    P.update(params or {})
    from ..loop.traffic import FloodTrafficPlan, ZipfUserPopulation
    from ..rec.cascade import CascadeEngine

    dev = device_lib.resolve(device)
    t_start = time.time()
    if publish_dir is None:
        publish_dir = build_cascade_artifact(
            os.path.join(workdir, "cache_publish"), say=say, device=dev)

    def serve_arm(cache_on):
        # A fresh same-seed population per arm: identical plans, so a
        # fingerprint delta could only come from the cache.
        population = ZipfUserPopulation(
            seed, users=P["users"], hist_len=P["hist_len"])
        plan = FloodTrafficPlan(
            seed + 1, offered_qps=P["offered_qps"],
            duration_s=P["duration_s"], population=population,
            field_size=TINY_MODEL["field_size"],
            feature_size=TINY_MODEL["feature_size"],
            repeat_p=P["repeat_p"])
        kw = {}
        if cache_on:
            kw = dict(cache_rows=P["cache_rows"], coalesce=True,
                      user_cache_rows=P["user_cache_rows"])
        eng = CascadeEngine(
            publish_dir, retrieve_k=P["retrieve_k"],
            max_batch=P["max_batch"], max_delay_ms=0.5,
            queue_rows=P["queue_rows"],
            watcher_kw={"poll_secs": 3600}, device=dev, **kw)
        h = hashlib.sha256()
        try:
            for r in plan.requests:
                ids_k, probs_k = eng.recommend(
                    r.hist_ids, r.hist_mask, r.ids[0], r.vals[0],
                    k=P["k"], timeout=P["timeout_s"], value=r.value)
                h.update(np.asarray(ids_k, np.int64).tobytes())
                h.update(np.asarray(probs_k, np.float32).tobytes())
            summary = eng.stats.summary()
        finally:
            eng.close()
        return {
            "requests": len(plan.requests),
            "repeat_requests": plan.repeat_requests,
            "fingerprint": h.hexdigest()[:16],
            "cache_hits": summary["serving_cache_hits"],
            "cache_misses": summary["serving_cache_misses"],
            "coalesced": summary["serving_coalesced"],
            "user_cache_hits": eng.user_cache_hits,
        }

    say("cache drill: serving the repeat flood with the fast path OFF")
    off = serve_arm(False)
    say("cache drill: same plan with the fast path ON")
    on = serve_arm(True)
    assert on["repeat_requests"] == off["repeat_requests"] > 0, (off, on)
    assert on["cache_hits"] > 0, (
        f"fast path ON served {on['requests']} requests "
        f"({on['repeat_requests']} repeats) with zero cache hits: {on}")
    assert off["cache_hits"] == 0, off
    bit_identical = on["fingerprint"] == off["fingerprint"]
    assert bit_identical, (
        f"cache-on responses diverged from cache-off: "
        f"{off['fingerprint']} vs {on['fingerprint']}")
    say(f"bit-identical arms ({on['fingerprint']}); "
        f"hits={on['cache_hits']} coalesced={on['coalesced']} "
        f"user_hits={on['user_cache_hits']}")
    return {
        "drill": "cache",
        "seed": seed,
        "params": {k: P[k] for k in sorted(P)},
        "off": off,
        "on": on,
        "bit_identical": bit_identical,
        "audit_fingerprint": on["fingerprint"],
        "device_kind": _device_kind(dev),
        "elapsed_s": round(time.time() - t_start, 1),
    }


def _experiment_batches(plan, batch_size, count):
    """Training batches built by cycling the traffic plan's rows:
    candidates train on the distribution they are judged on, and the
    batch stream is a pure function of the plan's seed."""
    ids_rows, vals_rows, y_rows = [], [], []
    for req in plan.requests:
        for r in range(int(req.ids.shape[0])):
            ids_rows.append(np.asarray(req.ids[r], np.int32))
            vals_rows.append(np.asarray(req.vals[r], np.float32))
            y_rows.append(float(req.labels[r]))
    repeats = -(-(batch_size * count) // len(y_rows))
    ids_rows *= repeats
    vals_rows *= repeats
    y_rows *= repeats
    out = []
    for b in range(count):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        out.append({
            "label": np.asarray(y_rows[sl], np.float32).reshape(
                batch_size, 1),
            "feat_ids": np.stack(ids_rows[sl]),
            "feat_vals": np.stack(vals_rows[sl]),
        })
    return out


def _window_auc(health):
    """A gate window's rows and AUC on each arm."""
    from ..serve.experiment import ARM_CHALLENGER, ARM_CONTROL
    ch, ctl = health.get(ARM_CHALLENGER, {}), health.get(ARM_CONTROL, {})
    return {"challenger_n": ch.get("n", 0), "challenger_auc": ch.get("auc"),
            "control_n": ctl.get("n", 0), "control_auc": ctl.get("auc")}


def _train_candidate(trainer, batches):
    """Fresh init, a few real train steps over ``batches`` (a list or any
    iterable: the NaN scenario passes a ``BatchPoisoner``)."""
    state = trainer.init_state()
    for b in batches:
        state, _ = trainer.train_step(state, trainer.put_batch(b))
    return state


def run_experiment_drill(workdir, *, seed=7, verbose=False, params=None,
                         model=None, device="cuda"):
    """Gated-deployment drill: shadow-validate, canary and auto-promote a
    healthy challenger, then detect, roll back and quarantine a
    NaN-poisoned, a latency-degraded and a stale-frozen challenger, with
    zero dropped or failed primary-lane requests throughout.

    The closed loop is serialized (each request's primary and shadow
    resolution completes before the next submit), so every prediction, and
    so every gate decision, pointer move and the audit fingerprint, is a
    function of the seed. Wall-clock latencies drive only the absolute-p99
    guardrail, whose margins are structural (an injected sleep above the
    ceiling against a warm engine far under it). Per-arm health recomputed
    from the impression log (arm + stamped float32 prediction + the plan's
    labels) must equal the online accumulation exactly.

    ``params`` overrides :data:`EXPERIMENT`; by default none at the JAX
    drill's model and :data:`EXPERIMENT_WIDE` at any other ``model``."""
    say = _say_factory(verbose)
    model = dict(TINY_MODEL if model is None else model)
    P = dict(EXPERIMENT)
    if params is None:
        params = {} if model == TINY_MODEL else EXPERIMENT_WIDE
    P.update(params)
    assert P["train_steps"] <= P["nan_train_batches"], P
    from ..data import tfrecord
    from ..loop import arm_health
    from ..loop import impressions as impressions_lib
    from ..serve.experiment import (ARM_CHALLENGER, ARM_CONTROL,
                                    ExperimentRouter)
    from ..train import Trainer
    from ..train import promote as promote_lib

    dev = device_lib.resolve(device)
    field_size = int(model["field_size"])
    t_start = time.time()
    engines = []
    try:
        os.makedirs(workdir, exist_ok=True)
        publish_dir = os.path.join(workdir, "publish")
        imp_dir = os.path.join(workdir, "impressions")

        schedule = faults_lib.ChaosSchedule.generate(
            seed, horizon_s=P["duration_s"],
            challenger_nan_events=1, challenger_nan_batches=2,
            challenger_slow_events=1, challenger_slow_ms=P["slow_ms"],
            challenger_stale_events=1)
        say(f"chaos {schedule.fingerprint()}: "
            + ", ".join(f"{e.kind}@{e.at_s:g}s" for e in schedule.events))
        plan = DiurnalTrafficPlan(
            seed, duration_s=P["duration_s"], base_qps=P["base_qps"],
            peak_qps=P["peak_qps"], feature_size=int(model["feature_size"]),
            field_size=field_size, max_rows=P["max_rows"])
        need = (4 * P["windows_required"]) * P["window_requests"] + 4
        assert len(plan.requests) >= need, (
            f"plan supplies {len(plan.requests)} requests, drill needs "
            f"{need}; raise duration_s/base_qps")

        cfg = Config(**model, batch_size=16, mesh_data=1, log_steps=0,
                     seed=seed, scale_lr_by_world=False)
        _bootstrap_v0(cfg, publish_dir, say, dev)  # LATEST -> 0 (+history)

        # ---- candidate builds (which poisons exist, and their
        # arguments, come from the chaos schedule) ----------------------
        trainer = Trainer(cfg, device=dev)
        batches = _experiment_batches(plan, cfg.batch_size,
                                      P["nan_train_batches"])
        state1 = _train_candidate(trainer, batches[:P["train_steps"]])
        export_lib.export_serving(trainer.servable_model(state1), cfg,
                                  os.path.join(publish_dir, "1"))
        say("candidate v1 (healthy) exported")

        scenarios = []    # (kind, version, expected breach reason)
        slow_delay_s = 0.0
        nan_poisoned = 0
        fired = set()
        for ev in schedule.due(P["duration_s"] + 1.0, fired):
            if ev.kind == "challenger_nan":
                # The real numerical-fault seam: arm the plan, take it as
                # the train task would, wrap the candidate's batches: its
                # params go NaN through training.
                faults_lib.set_nan_plan(ev.get("batches"))
                nan_plan = faults_lib.take_nan_plan()
                poisoner = faults_lib.BatchPoisoner(
                    batches, batches=nan_plan["batches"],
                    value=nan_plan["value"], key=nan_plan["key"])
                state2 = _train_candidate(trainer, poisoner)
                nan_poisoned = poisoner.poisoned
                export_lib.export_serving(trainer.servable_model(state2),
                                          cfg, os.path.join(publish_dir, "2"))
                say(f"candidate v2 (NaN-poisoned, {nan_poisoned} batches "
                    f"via set_nan_plan) exported")
                scenarios.append(("challenger_nan", "2",
                                  promote_lib.REASON_NONFINITE))
            elif ev.kind == "challenger_slow":
                # v3 = v1's params behind a degraded engine: only the
                # challenger's predicts are delayed.
                slow_delay_s = float(ev.get("delay_ms", 0.0)) / 1000.0
                scenarios.append(("challenger_slow", "3",
                                  promote_lib.REASON_LATENCY))
            elif ev.kind == "challenger_stale":
                # v4 = a frozen candidate; the staleness gate judges its
                # age alone, so it needs no artifact and no traffic.
                scenarios.append(("challenger_stale", "4",
                                  promote_lib.REASON_STALE))
        assert nan_poisoned >= 1, "nan poison seam never fired"
        assert slow_delay_s * 1000.0 > P["max_p99_ms"], (
            f"slow_ms {slow_delay_s * 1e3} must exceed the max_p99_ms "
            f"ceiling {P['max_p99_ms']} for detection-by-construction")

        # ---- engines ---------------------------------------------------
        buckets = export_lib.serving_buckets(P["serve_max_batch"])
        ekw = dict(max_batch=P["serve_max_batch"],
                   max_delay_ms=P["serve_max_delay_ms"], buckets=buckets)
        control = ServingEngine.serve_latest(
            publish_dir, poll_secs=0.05, device=dev, **ekw)
        engines.append(control)

        def candidate_engine(version, wrap=None):
            fn = export_lib.load_serving(
                os.path.join(publish_dir, version), buckets=tuple(buckets),
                device=dev)
            if wrap is not None:
                fn = wrap(fn)
            eng = ServingEngine(fn, **ekw)
            engines.append(eng)
            return eng

        def warm(eng):
            # Run every bucket a drill request can hit, so measured
            # latencies (the absolute-p99 gate's input) hold no first call.
            for n in range(1, P["max_rows"] + 1):
                eng.predict(np.zeros((n, field_size), np.int32),
                            np.ones((n, field_size), np.float32),
                            timeout=300)

        # ---- closed serving loop with shadow serialization -------------
        req_iter = iter(plan.requests)
        labels = {}              # impression id -> ground-truth label
        audit_samples = []       # (arm, label, prob, 0.0) in log order
        failures = []
        primary_nonfinite = [0]
        logger = ImpressionLogger(imp_dir, shard_records=SHARD_RECORDS)
        current_req = {}
        window_ch = {"samples": None}
        shadow_evt = threading.Event()
        primary_lat = []         # every primary response's latency (ms)

        def on_shadow(rid, probs, latency_ms):
            req = current_req[rid]
            probs = np.asarray(probs)
            logger.log_request(rid + SHADOW_IID_OFFSET, req.ids, req.vals,
                               req.t_s, arm=ARM_CHALLENGER, preds=probs)
            for k in range(int(req.ids.shape[0])):
                p = float(probs[k])
                window_ch["samples"].append(
                    (ARM_CHALLENGER, float(req.labels[k]), p,
                     float(latency_ms)))
                audit_samples.append(
                    (ARM_CHALLENGER, float(req.labels[k]), p, 0.0))
            shadow_evt.set()

        def serve_window(router, n_requests):
            ctl, ch = [], []
            window_ch["samples"] = ch
            for _ in range(n_requests):
                req = next(req_iter)
                current_req[req.first_id] = req
                expect_shadow = (
                    router.mode == "shadow" and not router.killed
                    and router.challenger is not None
                    and router.assign(req.first_id) == ARM_CHALLENGER)
                if expect_shadow:
                    shadow_evt.clear()
                try:
                    fut = router.submit(req.ids, req.vals, req.first_id)
                    probs = np.asarray(fut.result(timeout=60))
                except Exception as e:  # noqa: BLE001 — the loss gate
                    failures.append(f"req {req.first_id}: {e!r}")
                    continue
                if not np.all(np.isfinite(probs)):
                    primary_nonfinite[0] += 1
                # Serialize the shadow lane: this request's duplicate
                # resolves (hook included) before the next submit, so
                # challenger flushes never batch across requests.
                if expect_shadow and not shadow_evt.wait(30):
                    assert (router.shadow_errors
                            + router.shadow_submit_rejected) > 0, \
                        "shadow lane hung without a typed counter"
                arm = fut.arm if fut.arm is not None else ARM_CONTROL
                lat = float(fut.latency_ms or 0.0)
                primary_lat.append(lat)
                logger.log_request(req.first_id, req.ids, req.vals,
                                   req.t_s, model_version=fut.model_version,
                                   arm=arm, preds=probs)
                for k in range(int(req.ids.shape[0])):
                    y = float(req.labels[k])
                    labels[req.first_id + k] = y
                    p = float(probs[k])
                    (ch if arm == ARM_CHALLENGER else ctl).append(
                        (arm, y, p, lat))
                    audit_samples.append((arm, y, p, 0.0))
            return arm_health(ctl + ch)

        gates = promote_lib.GateConfig(
            min_samples=P["min_samples"], min_auc_delta=P["min_auc_delta"],
            max_p99_ratio=P["max_p99_ratio"], max_p99_ms=P["max_p99_ms"],
            max_nonfinite=0, max_calibration_err=P["max_calibration_err"],
            max_candidate_age_s=P["max_candidate_age_s"],
            windows_required=P["windows_required"])
        active_router = [None]

        def kill_switch(version, reason):
            if active_router[0] is not None:
                active_router[0].kill(f"{version}: {reason}")

        controller = promote_lib.PromotionController(
            publish_dir, gates=gates, on_rollback=kill_switch)
        decisions = []

        # ---- phase 1: shadow-validate the healthy challenger -----------
        ch1 = candidate_engine("1")
        warm(control)
        warm(ch1)
        r_shadow = ExperimentRouter(
            control, ch1, mode="shadow", seed=seed,
            challenger_permille=P["permille"],
            shadow_slo_ms=P["shadow_slo_ms"], on_shadow_result=on_shadow)
        active_router[0] = r_shadow
        shadow_windows = []
        for _ in range(P["windows_required"]):
            h = serve_window(r_shadow, P["window_requests"])
            passed, breaches, holds = promote_lib.evaluate_gates(
                h.get(ARM_CHALLENGER, {}), h.get(ARM_CONTROL, {}), gates)
            shadow_windows.append(
                {"passed": passed, "breaches": breaches, "holds": holds,
                 **_window_auc(h)})
            assert passed, (
                f"healthy challenger failed shadow validation: "
                f"breaches={breaches} holds={holds} health={h}")
        sh1 = r_shadow.summary()
        assert sh1["shadow_completed"] > 0 and sh1["shadow_errors"] == 0 \
            and sh1["shadow_nonfinite"] == 0, sh1
        r_shadow.close()
        say(f"shadow validation passed "
            f"({sh1['shadow_completed']} duplicates observed)")

        # ---- phase 2: canary + auto-promote -----------------------------
        assert controller.offer("1", now_s=0.0)
        r_canary = ExperimentRouter(
            control, ch1, mode="canary", seed=seed,
            challenger_permille=P["permille"])
        active_router[0] = r_canary
        canary_windows = []
        for _ in range(P["windows_required"]):
            h = serve_window(r_canary, P["window_requests"])
            d = controller.observe(h.get(ARM_CHALLENGER, {}),
                                   h.get(ARM_CONTROL, {}), now_s=1.0)
            decisions.append(d)
            canary_windows.append({"action": d.action,
                                   "reasons": list(d.reasons),
                                   **_window_auc(h)})
        assert decisions[-1].action == "promote", canary_windows
        deadline = time.monotonic() + 20
        while os.path.basename(control.watcher.current_path or "") != "1":
            assert time.monotonic() < deadline, \
                "control engine never hot-swapped to the promoted v1"
            time.sleep(0.02)
        serve_window(r_canary, 4)   # zero loss across the promotion swap
        r_canary.close()
        say("healthy challenger canaried and auto-promoted; LATEST -> 1")

        # ---- phase 3: poisoned challengers ------------------------------
        scen_reports = []
        for kind, version, reason in scenarios:
            if kind == "challenger_stale":
                ds = []
                for _ in range(2):
                    assert controller.offer(version, now_s=0.0)
                    ds.append(controller.observe(
                        {}, {}, now_s=P["stale_age_s"]))
            else:
                if kind == "challenger_nan":
                    eng = candidate_engine(version)
                else:
                    def slowed(fn):
                        def wrapped(ids, vals):
                            time.sleep(slow_delay_s)
                            return fn(ids, vals)
                        return wrapped
                    eng = candidate_engine("1", wrap=slowed)
                warm(eng)
                r = ExperimentRouter(
                    control, eng, mode="shadow", seed=seed,
                    challenger_permille=P["permille"],
                    shadow_slo_ms=P["shadow_slo_ms"],
                    on_shadow_result=on_shadow)
                active_router[0] = r
                ds = []
                for _ in range(2):
                    assert controller.offer(version, now_s=0.0)
                    r.revive()   # each offer earns a fresh shadow shot
                    h = serve_window(r, P["window_requests"])
                    ds.append(controller.observe(
                        h.get(ARM_CHALLENGER, {}),
                        h.get(ARM_CONTROL, {}), now_s=1.0))
                assert r.killed and version in (r.kill_reason or ""), (
                    f"kill-switch never pulled for {kind}: "
                    f"{r.kill_reason!r}")
                if kind == "challenger_slow":
                    assert r.shadow_slo_misses > 0, r.summary()
                r.close()
            assert ds[0].action == "rollback" and reason in ds[0].reasons, \
                (kind, ds)
            assert ds[1].action == "quarantine" \
                and reason in ds[1].reasons, (kind, ds)
            assert not controller.offer(version, now_s=0.0), (
                f"quarantined {version} was re-admitted")
            decisions.extend(ds)
            scen_reports.append({
                "kind": kind, "version": version,
                "expected_reason": reason,
                "decisions": [[d.action, d.version, list(d.reasons)]
                              for d in ds]})
            say(f"{kind}: v{version} rolled back ({reason}) "
                f"and quarantined")
        active_router[0] = None
        logger.close()

        # ---- gates -------------------------------------------------------
        stats = control.stats.summary()
        assert not failures, failures[:5]
        assert primary_nonfinite[0] == 0, (
            f"{primary_nonfinite[0]} primary responses went non-finite: "
            f"challenger poison leaked into the primary lane")
        assert stats["serving_failed"] == 0 \
            and stats["serving_overloads"] == 0, stats
        latest = export_lib.read_latest(publish_dir)
        assert latest is not None \
            and os.path.basename(latest) == "1", latest

        history = [(e["version"], e["actor"], e["reason"])
                   for e in export_lib.pointer_history(publish_dir)]
        actors = [a for _, a, _ in history]
        # One rollback line per scenario: the second rollback of the same
        # candidate carries the identical (version, actor, reason) and the
        # history's tail-dedupe absorbs it; the controller's counters
        # carry the multiplicity.
        assert actors[0] == "publish" and actors.count("promote") == 1 \
            and actors.count("quarantine") == len(scenarios) \
            and actors.count("rollback") == len(scenarios), history
        pstats = controller.stats()
        assert pstats["rollbacks"] == 2 * len(scenarios) \
            and pstats["quarantines"] == len(scenarios) \
            and pstats["promotions"] == 1, pstats

        # ---- per-arm health: online accumulation against a pure
        # recomputation from the impression log (exact) -------------------
        offline_samples = []
        for shard in logger.shards:
            for rec in tfrecord.iter_records(shard):
                s_arm, s_pred = impressions_lib.read_experiment(rec)
                if s_arm is None or s_pred is None:
                    continue
                iid, _, _, _ = impressions_lib.decode_impression(rec)
                offline_samples.append(
                    (s_arm, labels[iid % SHADOW_IID_OFFSET], s_pred, 0.0))
        online_health = arm_health(audit_samples)
        offline_health = arm_health(offline_samples)
        assert online_health == offline_health, (
            f"per-arm health diverged between online accumulation and the "
            f"impression-log recomputation:\n  online  {online_health}\n"
            f"  offline {offline_health}")
        say("per-arm health: online == offline recomputation (exact "
            f"over {len(audit_samples)} samples)")

        fingerprint = hashlib.sha256(json.dumps(
            {"schedule": schedule.to_json(),
             "plan": hashlib.sha256(
                 repr(plan.fingerprint_data()).encode()).hexdigest(),
             "params": {k: P[k] for k in sorted(P)},
             "history": history,
             "decisions": [[d.action, d.version, list(d.reasons)]
                           for d in decisions],
             "arm_health": {
                 str(a): {k: v for k, v in h.items()
                          if k != "p99_latency_ms"}
                 for a, h in online_health.items()},
             "outcomes": {"stable_version": "1",
                          "quarantined": sorted(controller.quarantined),
                          "primary_failed": len(failures),
                          "primary_nonfinite": primary_nonfinite[0],
                          "nan_batches_poisoned": nan_poisoned}},
            sort_keys=True).encode()).hexdigest()[:16]

        lat = np.asarray(primary_lat, np.float64)
        return {
            "drill": "experiment",
            "ok": True,
            "seed": seed,
            "params": {k: P[k] for k in sorted(P)},
            "chaos": {"fingerprint": schedule.fingerprint(),
                      "events": json.loads(schedule.to_json())["events"]},
            "shadow_validation": shadow_windows,
            "canary_windows": canary_windows,
            "shadow_summary": {k: sh1[k] for k in (
                "shadow_submitted", "shadow_completed", "shadow_errors",
                "shadow_nonfinite", "shadow_slo_misses")},
            "scenarios": scen_reports,
            "promotion": controller.stats(),
            "pointer_history": [
                {"version": v, "actor": a, "reason": r}
                for v, a, r in history],
            "primary": {"requests": stats["serving_requests"],
                        "failed": len(failures),
                        "overloads": stats["serving_overloads"],
                        "nonfinite": primary_nonfinite[0],
                        "hot_swaps": control.watcher.swap_count,
                        "p50_ms": (float(np.percentile(lat, 50))
                                   if lat.size else None),
                        "p99_ms": (float(np.percentile(lat, 99))
                                   if lat.size else None)},
            "arm_health_online": {str(a): h
                                  for a, h in online_health.items()},
            "arm_health_offline_match": True,
            "stable_version": "1",
            "nan_batches_poisoned": nan_poisoned,
            "audit_fingerprint": fingerprint,
            "model": model_of(cfg),
            "device_kind": _device_kind(dev),
            "load_kind": "synthetic-closed-loop-serialized",
            "elapsed_s": round(time.time() - t_start, 1),
        }
    finally:
        faults_lib.take_nan_plan()       # never leak an armed plan
        for eng in engines:
            try:
                eng.close(timeout=5)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="",
                    help="scratch dir (default: a fresh temporary one)")
    ap.add_argument("--seed", type=int, default=2026,
                    help="drill seed: traffic, label delays and the chaos "
                         "schedule all derive from it (default 2026)")
    ap.add_argument("--pace", type=float, default=1.0,
                    help="wall seconds per logical second (default 1.0)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the in-process smoke instead")
    ap.add_argument("--report", default="",
                    help="write the report here (default: none)")
    ap.add_argument("--trace", default="off",
                    choices=["off", "ring", "full"],
                    help="span tracing for every drill process; the report "
                         "gains a merged trace and the serve-vN/publish-vM "
                         "correlation")
    ap.add_argument("--tb", default="", dest="tb_dir",
                    help="write serving and loop scalars through the "
                         "TensorBoard writer into this directory")
    ap.add_argument("--width", choices=("tiny", "reference"), default="tiny",
                    help="the JAX drill's model, or Config()'s reference "
                         "width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model = reference_model() if args.width == "reference" else TINY_MODEL
    kw = dict(seed=args.seed, pace=args.pace, verbose=True,
              trace=args.trace, model=model, device=args.device)
    if not args.smoke:
        kw.update(report_path=args.report or None, tb_dir=args.tb_dir)
    runner = run_smoke if args.smoke else run_drill
    with tempfile.TemporaryDirectory(prefix="production_drill_") as d:
        report = runner(args.workdir or d, **kw)
    if args.smoke and args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print("[production_drill] PASS", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
