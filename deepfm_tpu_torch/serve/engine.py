"""Serving engine: queue → pipelined dynamic batcher → bucketed
predict.

The reference delegated serving to TF-Serving (``2-hvd-gpu/...py:429-431``
exports, a managed endpoint batches); this module is the in-repo engine that
closes the train→publish→serve loop. One device-owning process runs:

  * a **bounded request queue** — ``submit()`` admits up to
    ``queue_rows`` pending rows and then raises a typed
    :class:`ServerOverloaded` (backpressure a frontend can convert to a 429,
    never a hang);
  * a **priority lane** — requests of at most ``small_rows`` rows queue in
    a dedicated small lane with head-of-line bypass: every forming batch
    admits the small lane FIRST, so a cheap latency-sensitive request is
    never stranded behind a max-batch fill of large requests (0 disables
    the lane; per-lane p50/p99 land in :class:`ServingStats`);
  * a **pipelined dynamic batcher** — a batcher thread forms flushes
    (max-batch policy preempts a deadline anchored at the FIRST queued
    request across both lanes) and hands them to an executor thread over a
    bounded in-flight window (``inflight``, default 2): while flush k runs
    on the device, flush k+1 is already admitting and forming, so batch
    formation never serializes behind device execution (``inflight=1``
    restores the strict flush-then-refill pipeline depth);
  * **bucketed batch shapes** — each flush pads to the next bucket
    (``utils.export.padded_predict``), so at most ``len(buckets)`` predict
    programs ever compile no matter what sizes traffic brings;
  * a **response demux** — padding stripped, per-request futures resolved
    with per-request latency stamps (admission → resolution). The demux is
    shape-agnostic: a single-output model resolves each future with probs
    ``[n]`` (the historical wire shape, unchanged), a multitask artifact
    with a ``{task_name: probs[n]}`` dict — whatever structure the predict
    fn returns, rows are sliced per request.

Hot swap rides the existing :class:`~deepfm_tpu_torch.utils.export.LatestWatcher`:
pass a watcher as ``predict_fn`` (or use :meth:`ServingEngine.serve_latest`)
and a newly published artifact is loaded off to the side and swapped in with
one assignment — the flush that is executing keeps the function reference it
already read, so in-flight batches finish on the old model and no request is
ever dropped or failed by a swap. A failed load keeps the current model
(``LatestWatcher.swap_failures`` counts it). Each flush is stamped with the
model VERSION that executed it (``LatestWatcher.current()``), so the
measured swap blackout is swap→first-flush-of-the-new-version — an
old-model flush completing after the swap (routine under pipelining) cannot
close the window early.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as trace_lib
from ..utils import faults as faults_lib
from .admission import VALUE_DEFAULT, AdmissionController
from .cache import ResultCache, request_fingerprint
from .stats import LANE_LARGE, LANE_SMALL, ServingStats


class ServerOverloaded(RuntimeError):
    """The bounded request queue is full (or the engine is shut down).

    The typed backpressure signal: callers retry with backoff or shed load;
    the engine never blocks a submitter and never silently drops a request.
    (A policy refusal of a low-value class under pressure is the distinct
    :class:`~deepfm_tpu_torch.serve.admission.AdmissionShed`.)
    """


class ServeTimeout(TimeoutError):
    """A future did not resolve within the caller's budget.

    Typed so frontends can forward it over the wire distinctly from a
    predict failure: the request may STILL complete server-side (the engine
    never abandons an admitted request) — only this caller stopped waiting.
    """


class ServeFuture:
    """One request's pending result: resolved by the batcher's demux.

    Resolution is first-wins and idempotent: under request hedging two
    engine legs may race to resolve the caller-visible result, and a
    cancelled loser that was already mid-flush resolves harmlessly (the
    canceller ignores it). ``add_done_callback`` fires exactly once, after
    the winning resolution, outside the future's lock.
    """

    __slots__ = ("ids", "vals", "n", "lane", "value", "t_enqueue",
                 "latency_ms", "trace_id", "model_version", "arm",
                 "fingerprint", "cache_hit", "coalesced", "cache_bypass",
                 "_event", "_probs", "_error", "_lock", "_callbacks",
                 "_cancelled", "_followers")

    def __init__(self, ids: np.ndarray, vals: np.ndarray, t_enqueue: float,
                 lane: str = LANE_LARGE, trace_id: Optional[int] = None,
                 value: str = VALUE_DEFAULT):
        self.ids = ids
        self.vals = vals
        self.n = int(ids.shape[0])
        self.lane = lane
        self.value = value                  # admission value class
        self.t_enqueue = t_enqueue
        self.latency_ms: Optional[float] = None
        self.trace_id = trace_id            # correlation id (obs.trace)
        self.model_version: Optional[int] = None  # stamped by the flush
        self.arm: Optional[int] = None      # stamped by ExperimentRouter
        self.fingerprint: Optional[bytes] = None  # request content hash
        self.cache_hit = False              # resolved from the result cache
        self.coalesced = False              # joined an in-flight leader
        self.cache_bypass = False           # shadow lane: no cache, ever
        self._event = threading.Event()
        self._probs: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._callbacks: List[Callable[["ServeFuture"], None]] = []
        self._cancelled = False
        self._followers: List["ServeFuture"] = []  # coalesced joins

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Best-effort: a cancelled future still waiting in the queue is
        dropped at batch formation or flush start (never executed); one
        already mid-predict resolves normally and the canceller ignores
        the result. Returns False if the future had already resolved.

        A coalesce LEADER with followers attached refuses cancellation
        outright (returns False without marking): other callers' responses
        fan out from this future's resolution, so a hedge race won
        elsewhere must not unresolve them."""
        with self._lock:
            if self._followers:
                return False
            self._cancelled = True
            return not self._event.is_set()

    def attach_follower(self, fut: "ServeFuture") -> bool:
        """Register ``fut`` as a coalesced follower of this in-flight
        leader; from now on :meth:`cancel` refuses (the leader carries
        other callers' responses). False if this future is already
        cancelled — the caller must submit normally instead."""
        with self._lock:
            if self._cancelled:
                return False
            self._followers.append(fut)
            return True

    def add_done_callback(self,
                          fn: Callable[["ServeFuture"], None]) -> None:
        """Run ``fn(self)`` once the future resolves (immediately if it
        already has). Callbacks run on the resolving thread, outside the
        future's lock — keep them cheap and non-blocking."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self) -> Optional[list]:
        """Under ``_lock``: claim the resolution; None if already done."""
        if self._event.is_set():
            return None
        cbs, self._callbacks = self._callbacks, []
        return cbs

    def set_result(self, probs: np.ndarray, latency_ms: float) -> None:
        with self._lock:
            cbs = self._resolve()
            if cbs is None:
                return
            self._probs = probs
            self.latency_ms = latency_ms
            self._event.set()
        for cb in cbs:
            cb(self)

    def set_error(self, exc: BaseException) -> None:
        with self._lock:
            cbs = self._resolve()
            if cbs is None:
                return
            self._error = exc
            self._event.set()
        for cb in cbs:
            cb(self)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the probs — ``[n]`` for single-output models,
        ``{task_name: [n]}`` for multitask artifacts; raises the predict
        error if the flush failed, typed :class:`ServeTimeout` if not
        resolved in ``timeout``."""
        if not self._event.wait(timeout):
            raise ServeTimeout(
                f"request of {self.n} rows unresolved after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._probs


class ServingEngine:
    """Bounded queue + pipelined batcher + bucketed jitted predict + demux.

    **Fast path** (both off by default — exact pre-existing behavior):
    ``cache_rows`` > 0 arms a version-keyed LRU result cache
    (:class:`~deepfm_tpu_torch.serve.cache.ResultCache`): a submit whose
    ``(ids, vals)`` bytes match a response already flushed under the
    CURRENT model version resolves immediately, bit-identical to the
    cached flush; hot swaps invalidate for free because the key carries
    the version. ``coalesce=True`` additionally attaches concurrent
    byte-identical requests to one in-flight leader future — one device
    execution fans out to every joined caller (typed, first-wins, with
    the leader refusing cancellation while it carries followers).
    ``submit(..., bypass_cache=True)`` opts a single request out of BOTH
    (lookup, insert, and coalescing) — the shadow lane's honesty hook.
    """

    #: ExperimentRouter probes this to route ``bypass_cache`` safely.
    supports_cache_bypass = True

    def __init__(self, predict_fn: Callable[[np.ndarray, np.ndarray],
                                            np.ndarray], *,
                 max_batch: int = 256, max_delay_ms: float = 5.0,
                 queue_rows: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 inflight: int = 2, small_rows: int = 0,
                 cache_rows: int = 0, cache_ttl_s: float = 0.0,
                 coalesce: bool = False,
                 stats: Optional[ServingStats] = None,
                 admission: Optional[AdmissionController] = None,
                 admission_kw: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        from ..utils import export as export_lib  # lazy: loads torch
        self._export = export_lib
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if small_rows < 0 or small_rows > max_batch:
            raise ValueError(
                f"small_rows must be in 0..max_batch={max_batch}, "
                f"got {small_rows}")
        self._fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.queue_rows_requested = int(queue_rows)
        self.queue_rows = int(queue_rows) if queue_rows else 8 * self.max_batch
        if self.queue_rows < self.max_batch:
            raise ValueError(
                f"queue_rows ({self.queue_rows}) must hold at least one "
                f"max_batch ({self.max_batch})")
        self.inflight = int(inflight)
        self.small_rows = int(small_rows)
        bucket_src = (buckets if buckets is not None
                      else export_lib.serving_buckets(self.max_batch))
        self.buckets = tuple(sorted({int(b) for b in bucket_src}
                                    | {self.max_batch}))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        if cache_rows < 0:
            raise ValueError(f"cache_rows must be >= 0, got {cache_rows}")
        if cache_ttl_s < 0:
            raise ValueError(f"cache_ttl_s must be >= 0, got {cache_ttl_s}")
        self.cache: Optional[ResultCache] = (
            ResultCache(cache_rows, ttl_s=cache_ttl_s, clock=clock)
            if cache_rows > 0 else None)
        self.coalesce = bool(coalesce)
        self._fp_lock = threading.Lock()
        self._inflight_fp: dict = {}   # fingerprint -> leader ServeFuture
        self.stats = stats if stats is not None else ServingStats(clock)
        self.stats.set_policy(
            serve_queue_rows=self.queue_rows,
            serve_queue_rows_auto=(self.queue_rows_requested == 0),
            serve_inflight=self.inflight,
            serve_small_rows=self.small_rows,
            serve_cache_rows=int(cache_rows),
            serve_cache_ttl_s=float(cache_ttl_s),
            serve_coalesce=self.coalesce)
        self._clock = clock
        # SLO-aware admission gate (optional). ``admission_kw`` builds a
        # controller bound to THIS engine's queue/stats/clock — the form
        # replica constructors use, so each replica gets its own gate
        # (pressure is per-queue; sharing one would gate on stale state).
        if admission is None and admission_kw:
            admission = AdmissionController(
                queue_rows=self.queue_rows, stats=self.stats, clock=clock,
                **admission_kw)
        self._admission = admission
        if admission is not None:
            if admission.stats is None:
                admission.stats = self.stats
            self.stats.set_policy(
                serve_shed_watermark=admission.shed_watermark,
                serve_slo_ms=admission.slo_ms)
        self._cond = threading.Condition()
        self._queue: deque = deque()        # large lane (FIFO)
        self._small: deque = deque()        # priority lane (FIFO, pops first)
        self._queued_rows = 0
        self._closing = False
        # Pipeline handoff: formed batches wait here for the executor, at
        # most `inflight` formed-but-uncompleted at any instant.
        self._exec_cond = threading.Condition()
        self._exec_queue: deque = deque()
        self._exec_inflight = 0             # handed off, not yet completed
        self._exec_done = False             # batcher exited; drain and stop
        self._watcher = None        # owned LatestWatcher (serve_latest)
        self._batcher: Optional[threading.Thread] = None
        self._executor: Optional[threading.Thread] = None
        if start:
            self.start()

    def __repr__(self) -> str:
        qr = (f"{self.queue_rows} (resolved from 0)"
              if self.queue_rows_requested == 0 else str(self.queue_rows))
        return (f"ServingEngine(max_batch={self.max_batch}, "
                f"max_delay_ms={self.max_delay_s * 1000.0:g}, "
                f"queue_rows={qr}, inflight={self.inflight}, "
                f"small_rows={self.small_rows}, buckets={self.buckets})")

    # ------------------------------------------------------- construction
    @classmethod
    def from_config(cls, cfg: Any, predict_fn: Callable,
                    **kw: Any) -> "ServingEngine":
        """Engine with the ``--serve_*`` policy of ``cfg``."""
        kw.setdefault("max_batch", cfg.serve_max_batch)
        kw.setdefault("max_delay_ms", cfg.serve_max_delay_ms)
        kw.setdefault("queue_rows", cfg.serve_queue_rows)
        kw.setdefault("inflight", cfg.serve_inflight)
        kw.setdefault("small_rows", cfg.serve_small_rows)
        kw.setdefault("cache_rows", cfg.serve_cache_rows)
        kw.setdefault("cache_ttl_s", cfg.serve_cache_ttl_s)
        kw.setdefault("coalesce", cfg.serve_coalesce)
        if cfg.serve_slo_ms > 0 or cfg.serve_shed_watermark > 0:
            kw.setdefault("admission_kw", {
                "slo_ms": cfg.serve_slo_ms,
                "shed_watermark": cfg.serve_shed_watermark})
        bucket_list = cfg.serve_bucket_sizes
        if bucket_list:
            kw.setdefault("buckets", bucket_list)
        return cls(predict_fn, **kw)

    @classmethod
    def serve_latest(cls, publish_dir: str, *, poll_secs: float = 2.0,
                     watcher_kw: Optional[dict] = None,
                     **kw: Any) -> "ServingEngine":
        """Engine following ``<publish_dir>/LATEST`` with hot swap.

        The watcher is owned: closed with the engine, and every swap it
        performs is stamped into the engine's stats (the blackout series,
        versioned — the blackout closes at the first flush that EXECUTED
        the new version). The watcher's loader is bucketed with the
        ENGINE's own ladder, so the pre-swap warm-up
        (``LatestWatcher._warm_buckets``) compiles exactly the shapes the
        engine will flush — the near-zero-blackout contract the serving
        drill asserts. (The engine pads flushes to the same buckets, so
        the inner BucketedPredict passes through.)
        """
        from ..utils import export as export_lib  # lazy: loads torch
        stats = kw.pop("stats", None) or ServingStats(
            kw.get("clock", time.monotonic))
        max_batch = int(kw.get("max_batch", 256))
        bucket_src = (kw.pop("buckets", None)
                      or export_lib.serving_buckets(max_batch))
        resolved = tuple(sorted({int(b) for b in bucket_src} | {max_batch}))
        wkw = dict(watcher_kw or {})
        wkw.setdefault("loader", lambda path: export_lib.load_serving(
            path, buckets=resolved))
        wkw.setdefault("on_error",
                       lambda exc: stats.record_watcher_error())
        # The watcher's initial check_once fires on_swap from inside
        # watch_latest, before the name `watcher` binds — the box carries
        # the late binding (the initial load is always version 1).
        box: list = []

        def _on_swap(path: str) -> None:
            version = box[0].swap_count if box else 1
            # Version 1 is the initial LOAD, not a hot swap: nothing was
            # served before it, so there is no response stream to black
            # out. (Under staggered replica bring-up, counting it would
            # report the fleet's slowest initial load as a fake blackout
            # on the fastest replica.)
            if version > 1:
                stats.record_swap(version)

        watcher = export_lib.watch_latest(
            publish_dir, poll_secs=poll_secs, on_swap=_on_swap, **wkw)
        box.append(watcher)
        engine = cls(watcher, stats=stats, buckets=resolved, **kw)
        engine._watcher = watcher
        return engine

    @property
    def watcher(self):
        return self._watcher

    @property
    def admission(self) -> Optional[AdmissionController]:
        return self._admission

    # ------------------------------------------------------------- client
    def submit(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
               trace_id: Optional[int] = None,
               value: str = VALUE_DEFAULT,
               bypass_cache: bool = False) -> ServeFuture:
        """Enqueue one request ``(ids[n,F], vals[n,F])``; returns its
        future. Requests of at most ``small_rows`` rows enter the priority
        lane. ``trace_id`` (see ``obs.trace.new_trace_id``) rides the
        future and is stamped into the flush's trace span for
        request→model-version correlation. ``value`` is the admission
        value class (lowest shed first under pressure; ignored without an
        admission controller). ``bypass_cache`` opts this request out of
        the result cache AND in-flight coalescing entirely (no lookup, no
        insert, no join — the shadow lane's honesty contract). Raises
        :class:`~deepfm_tpu_torch.serve.admission.AdmissionShed` when the gate
        refuses the class, :class:`ServerOverloaded` when the queue is
        full or the engine is shutting down, ValueError on malformed
        shapes."""
        ids = np.asarray(feat_ids)
        vals = np.asarray(feat_vals)
        if ids.ndim != 2 or vals.shape != ids.shape:
            raise ValueError(
                f"expected feat_ids/feat_vals of one [n, F] shape, got "
                f"{ids.shape} / {vals.shape}")
        n = int(ids.shape[0])
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"request of {n} rows outside 1..max_batch={self.max_batch} "
                "(split oversized requests client-side)")
        small = 0 < n <= self.small_rows
        fut = ServeFuture(ids, vals, self._clock(),
                          lane=LANE_SMALL if small else LANE_LARGE,
                          trace_id=trace_id, value=value)
        fut.cache_bypass = bool(bypass_cache)
        fast = (self.cache is not None or self.coalesce) \
            and not fut.cache_bypass
        if fast:
            # Fingerprint once; rides the future to the flush demux (the
            # cache insert point) and keys the in-flight coalesce registry.
            fut.fingerprint = request_fingerprint(ids, vals)
            if self.cache is not None:
                version = self._cache_version()
                hit = self.cache.get(version, fut.fingerprint)
                if hit is not None:
                    # Bit-identical to the flush that stored it; resolved
                    # here, before admission — a hit consumes no queue
                    # rows and no device time.
                    fut.cache_hit = True
                    fut.model_version = version
                    lat = 1000.0 * (self._clock() - fut.t_enqueue)
                    self.stats.record_cache_hit()
                    trace_lib.instant("serve.cache", event="hit", rows=n,
                                      trace_id=trace_id)
                    fut.set_result(hit, latency_ms=lat)
                    self.stats.record_request_done(lat, lane=fut.lane)
                    return fut
                self.stats.record_cache_miss()
            if self.coalesce:
                with self._fp_lock:
                    leader = self._inflight_fp.get(fut.fingerprint)
                if leader is not None and leader is not fut \
                        and leader.attach_follower(fut):
                    fut.coalesced = True
                    self.stats.record_coalesced()
                    trace_lib.instant("serve.cache", event="coalesce",
                                      rows=n, trace_id=trace_id)
                    leader.add_done_callback(
                        lambda done, f=fut: self._fan_out(done, f))
                    return fut
        with self._cond:
            if self._closing:
                self.stats.record_overload()
                raise ServerOverloaded("serving engine is shut down")
            if self._admission is not None:
                # Value-aware gate BEFORE the queue-full wall: under
                # pressure low classes get a typed AdmissionShed while the
                # queue still has room for high-value work.
                self._admission.admit(value, self._queued_rows)
            if self._queued_rows + n > self.queue_rows:
                self.stats.record_overload()
                raise ServerOverloaded(
                    f"request queue full ({self._queued_rows} rows pending, "
                    f"limit {self.queue_rows}); retry with backoff")
            (self._small if small else self._queue).append(fut)
            self._queued_rows += n
            self._cond.notify_all()
        if fast and self.coalesce:
            # Become the in-flight leader for this fingerprint AFTER the
            # enqueue succeeded (a refused request must never be joined).
            # Two racing identical submits can both enqueue — benign: the
            # later registration wins and future joins attach to it.
            with self._fp_lock:
                self._inflight_fp[fut.fingerprint] = fut
            fut.add_done_callback(self._fp_release)
        return fut

    def _fan_out(self, leader: ServeFuture, follower: ServeFuture) -> None:
        """Resolve one coalesced follower from its leader's resolution
        (runs on the resolving thread). Copies, so followers never alias
        the leader's arrays; errors propagate typed."""
        now = self._clock()
        lat = 1000.0 * (now - follower.t_enqueue)
        follower.model_version = leader.model_version
        if leader._error is not None:
            self.stats.record_request_failed()
            follower.set_error(leader._error)
            return
        probs = leader._probs
        if isinstance(probs, dict):
            probs = {k: np.array(v, copy=True) for k, v in probs.items()}
        else:
            probs = np.array(probs, copy=True)
        follower.set_result(probs, latency_ms=lat)
        self.stats.record_request_done(lat, lane=follower.lane)

    def _fp_release(self, fut: ServeFuture) -> None:
        """Leader resolved: retire its coalesce-registry entry (unless a
        newer leader already took the fingerprint over)."""
        with self._fp_lock:
            if self._inflight_fp.get(fut.fingerprint) is fut:
                self._inflight_fp.pop(fut.fingerprint, None)

    def _cache_version(self):
        """The cache key's model-version component for a request admitted
        NOW: the installed artifact step when one is known, else the
        watcher swap ordinal, else None (a plain static predict fn — one
        version forever). Matches what :meth:`_flush` stamps at insert, so
        a hot swap strands old entries unreachable (invalidated for
        free)."""
        step = self._model_step()
        if step is not None:
            return step
        current = getattr(self._fn, "current", None)
        if callable(current):
            return current()[1]
        return None

    def predict(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
                timeout: Optional[float] = None,
                trace_id: Optional[int] = None,
                value: str = VALUE_DEFAULT) -> np.ndarray:
        """Synchronous convenience: ``submit().result()``."""
        return self.submit(feat_ids, feat_vals, trace_id=trace_id,
                           value=value).result(timeout)

    # ------------------------------------------------------------ batcher
    def start(self) -> "ServingEngine":
        if self._batcher is None:
            self._batcher = threading.Thread(
                target=self._run_batcher, name="serving-batcher", daemon=True)
            self._executor = threading.Thread(
                target=self._run_executor, name="serving-executor",
                daemon=True)
            self._batcher.start()
            self._executor.start()
        return self

    def _run_batcher(self) -> None:
        """Form flushes and hand them to the executor over the bounded
        in-flight window; while flush k executes, flush k+1 forms here."""
        while True:
            with trace_lib.span("serve.batch") as sp:
                batch, rows = self._collect()
                sp.add(rows=rows, requests=len(batch))
            if not batch:
                with self._exec_cond:
                    self._exec_done = True
                    self._exec_cond.notify_all()
                return  # closed and drained
            with trace_lib.span("serve.handoff_wait"), self._exec_cond:
                while self._exec_inflight >= self.inflight:
                    self._exec_cond.wait()
                self._exec_queue.append((batch, rows))
                self._exec_inflight += 1
                self._exec_cond.notify_all()

    def _run_executor(self) -> None:
        while True:
            with self._exec_cond:
                while not self._exec_queue and not self._exec_done:
                    self._exec_cond.wait()
                if not self._exec_queue:
                    return  # batcher exited and the pipeline is drained
                batch, rows = self._exec_queue.popleft()
            try:
                self._flush(batch, rows)
            finally:
                with self._exec_cond:
                    self._exec_inflight -= 1
                    self._exec_cond.notify_all()

    def _head_enqueue_time(self) -> float:
        """Earliest enqueue time across both lane heads (caller holds
        ``_cond`` and at least one lane is non-empty)."""
        heads = [q[0].t_enqueue for q in (self._small, self._queue) if q]
        return min(heads)

    def _collect(self) -> tuple:
        """Block until a flush is due; pop and return it. Empty = exit.

        The small lane has head-of-line bypass: it fills the batch FIRST,
        so a priority request is never stranded behind a max-batch fill of
        larges — worst case it waits out the flush currently forming plus
        the in-flight window, never a whole queue of large rows.
        """
        with self._cond:
            while True:
                while not (self._queue or self._small) and not self._closing:
                    self._cond.wait()
                if not (self._queue or self._small):
                    return [], 0
                if not self._closing and self.max_delay_s > 0:
                    # Deadline anchored at the FIRST queued request (either
                    # lane): a single request waits at most max_delay_ms. A
                    # full max_batch of rows arriving earlier preempts it.
                    deadline = self._head_enqueue_time() + self.max_delay_s
                    while self._queued_rows < self.max_batch \
                            and not self._closing:
                        remaining = deadline - self._clock()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                batch: List[ServeFuture] = []
                rows = 0
                dropped = 0     # cancelled rows popped but never flushed
                while self._small \
                        and rows + self._small[0].n <= self.max_batch:
                    fut = self._small.popleft()
                    if fut.cancelled():
                        dropped += fut.n
                        continue
                    rows += fut.n
                    batch.append(fut)
                while self._queue \
                        and rows + self._queue[0].n <= self.max_batch:
                    fut = self._queue.popleft()
                    if fut.cancelled():
                        dropped += fut.n
                        continue
                    rows += fut.n
                    batch.append(fut)
                self._queued_rows -= rows + dropped
                if not batch:
                    # Everything popped was a cancelled hedge loser — this
                    # is NOT the drained-shutdown signal; re-wait.
                    continue
                if self._admission is not None:
                    # Queue-delay signal: enqueue -> batch formation, the
                    # part of the SLO the gate can still protect.
                    now = self._clock()
                    for fut in batch:
                        self._admission.observe_delay(
                            1000.0 * (now - fut.t_enqueue))
                return batch, rows

    def _snapshot_fn(self) -> Tuple[Callable, Optional[int]]:
        """The predict fn to execute plus the model version it represents
        (``LatestWatcher.current()``); a plain fn has no version."""
        fn = self._fn
        current = getattr(fn, "current", None)
        if callable(current):
            return current()
        return fn, None

    def _model_step(self) -> Optional[int]:
        """Artifact step of the CURRENTLY installed model (the basename of
        ``LatestWatcher.current_path``); None for plain predict fns or
        non-numeric paths. Read race-tolerantly — a concurrent swap can
        move the path between flushes, and the span stamp is advisory."""
        path = getattr(self._fn, "current_path", None)
        if not path:
            return None
        try:
            return int(os.path.basename(os.path.normpath(path)))
        except (TypeError, ValueError):
            return None

    def _flush(self, batch: List[ServeFuture], rows: int) -> None:
        # Last-chance drop BEFORE any device work: a future cancelled (or
        # somehow resolved) after batch formation but before this flush
        # began — the hedge-loser race window — is filtered here, so a won
        # race never double-computes. Rows are re-counted; an emptied
        # flush costs nothing.
        live = [f for f in batch if not (f.cancelled() or f.done())]
        if len(live) != len(batch):
            trace_lib.instant("serve.flush_dropped",
                              requests=len(batch) - len(live))
            batch = live
            rows = sum(f.n for f in batch)
        if not batch:
            return
        if len(batch) == 1:
            ids, vals = batch[0].ids, batch[0].vals
        else:
            ids = np.concatenate([f.ids for f in batch])
            vals = np.concatenate([f.vals for f in batch])
        bucket = self._export.next_bucket(rows, self.buckets)
        fn, version = self._snapshot_fn()
        step = self._model_step()
        for fut in batch:
            # Published artifact step when the watcher serves a versioned
            # dir (what impressions correlate against); swap ordinal
            # otherwise.
            fut.model_version = step if step is not None else version
        sp = trace_lib.span("serve.flush", rows=rows, bucket=bucket,
                            requests=len(batch))
        if version is not None:
            sp.add(model_version=version)
        if step is not None:
            sp.add(model_step=step)
        tids = [f.trace_id for f in batch if f.trace_id is not None]
        if tids:
            sp.add(trace_ids=tids[:64])  # bounded per-event payload
        with sp:
            # Chaos seam: an armed executor_slow fault (utils.faults) adds
            # injected latency per flush — how the drill drives the
            # degradation ladder without depending on host speed.
            slow_s = faults_lib.executor_slow_delay()
            if slow_s > 0:
                trace_lib.instant("serve.executor_slow", delay_s=slow_s)
                time.sleep(slow_s)
            try:
                out = self._export.padded_predict(fn, ids, vals, self.buckets)
            except Exception as exc:  # noqa: BLE001 — forwarded per-request
                for fut in batch:
                    self.stats.record_request_failed()
                    fut.set_error(exc)
                return
            now = self._clock()
            off = 0
            cache_key = step if step is not None else version
            if isinstance(out, dict):
                # Multitask artifact: named per-task probability columns,
                # each sliced per request — futures resolve with
                # {task: probs[n]}.
                named = {k: np.asarray(v) for k, v in out.items()}
                for fut in batch:
                    # Record the latency computed HERE, not fut.latency_ms:
                    # a future something else already resolved (a hedged
                    # loser mid-flush) keeps its first-wins stamp and this
                    # set_result is a no-op.
                    lat = 1000.0 * (now - fut.t_enqueue)
                    sliced = {k: v[off:off + fut.n]
                              for k, v in named.items()}
                    self._cache_insert(fut, cache_key, sliced)
                    fut.set_result(sliced, latency_ms=lat)
                    off += fut.n
                    self.stats.record_request_done(lat, lane=fut.lane)
            else:
                # Single-output: the historical wire shape [n], bit-unchanged.
                probs = np.asarray(out).reshape(-1)
                for fut in batch:
                    lat = 1000.0 * (now - fut.t_enqueue)
                    sliced = probs[off:off + fut.n]
                    self._cache_insert(fut, cache_key, sliced)
                    fut.set_result(sliced, latency_ms=lat)
                    off += fut.n
                    self.stats.record_request_done(lat, lane=fut.lane)
            self.stats.record_flush(rows, bucket,
                                    full=rows >= self.max_batch,
                                    version=version)

    def _cache_insert(self, fut: ServeFuture, cache_key, value) -> None:
        """Store one demuxed response under the version that EXECUTED it
        (insert-side half of the version-keyed contract). Bypass futures
        carry no fingerprint, so the shadow lane neither reads nor warms
        the cache."""
        if self.cache is not None and fut.fingerprint is not None:
            self.cache.put(cache_key, fut.fingerprint, value, fut.n)

    # ---------------------------------------------------------- lifecycle
    @property
    def pending_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admitting, DRAIN the queue and the in-flight pipeline
        (every admitted request gets its response), join both threads,
        close an owned watcher."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout=timeout)
            self._batcher = None
        if self._executor is not None:
            self._executor.join(timeout=timeout)
            self._executor = None
        if self._watcher is not None:
            self._watcher.close()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
