"""Replica scale-out: N serving engines behind one frontend.

(The port's copy of ``deepfm_tpu.serve.replicas``.) One
:class:`~deepfm_tpu_torch.serve.engine.ServingEngine` owns one device (or one
host time-slice); serving "millions of users" means running several behind
the same shm_ring frontend. :class:`ReplicatedEngine` presents the ENGINE
interface the frontend already speaks (``submit`` / ``pending_rows`` /
``close``) over a fleet of replicas, adding exactly three things:

  * **sticky routing with least-loaded spill** — a request carrying an
    ``affinity`` key (the frontend passes its client id) lands on the same
    replica every time, so per-client traffic keeps its admission order and
    one client's burst warms one replica's batcher. When the sticky replica
    is overloaded (typed :class:`ServerOverloaded`), the request spills to
    the least-loaded other replica by pending rows — and only if EVERY
    replica refuses does the caller see the overload. A closed/dead replica
    is just a replica that refuses: requests re-route with the same typed
    error path, never a hang.
  * **per-replica model slots with STAGGERED hot swap** — each replica owns
    its own :class:`~deepfm_tpu_torch.utils.export.LatestWatcher` (created with
    ``start=False``: no per-replica poll threads), and ONE coordinator
    thread walks the fleet sequentially calling ``check_once()``. A swap —
    including its off-to-the-side bucket prewarm — completes on replica k
    before replica k+1 even looks at LATEST, so the fleet never pays all
    its (already near-zero) blackouts at the same instant and old/new model
    versions briefly co-serve, exactly like a rolling production rollout.
  * **aggregate stats** —
    :func:`~deepfm_tpu_torch.serve.stats.aggregate_summary` over the replicas' reservoirs: true fleet percentiles (concatenated
    latencies, not averaged percentiles), union-window QPS, and the
    worst-replica blackout plus the per-replica list the drill gates on.

Scaling honesty: the replicas of one process share its card (each engine
loads its model onto the default device, as the JAX replicas share the
default device) and its host cores, so aggregate QPS scales only as far as
the host-bound flushes overlap; this module makes no claim that it does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs import trace as trace_lib
from .admission import VALUE_DEFAULT, AdmissionShed
from .engine import ServeFuture, ServerOverloaded, ServeTimeout, \
    ServingEngine
from .stats import aggregate_summary


class HedgedFuture:
    """A caller-visible future over one or two engine legs: the primary
    submission plus (possibly) one hedge fired to another replica. First
    resolution wins — the loser is cancelled and counted, and the wrapper
    resolves exactly once (the engine futures are themselves first-wins, so
    a cancelled loser mid-flush resolving late is harmless).

    An errored leg does NOT resolve the wrapper while the other leg is
    still pending: a failed primary with a healthy hedge in flight waits
    for the hedge (and vice versa) — the caller only sees an error when no
    leg can succeed.
    """

    __slots__ = ("n", "lane", "value", "trace_id", "t_enqueue",
                 "latency_ms", "model_version", "home_idx", "_primary",
                 "_hedge", "_event", "_lock", "_winner", "_stats", "_clock")

    def __init__(self, primary: ServeFuture, *, home_idx: int, stats: Any,
                 clock: Callable[[], float]):
        self.n = primary.n
        self.lane = primary.lane
        self.value = primary.value
        self.trace_id = primary.trace_id
        self.t_enqueue = primary.t_enqueue
        self.latency_ms: Optional[float] = None
        self.model_version: Optional[int] = None
        self.home_idx = home_idx
        self._primary = primary
        self._hedge: Optional[ServeFuture] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._winner: Optional[ServeFuture] = None
        self._stats = stats
        self._clock = clock
        primary.add_done_callback(self._child_done)

    @property
    def hedged(self) -> bool:
        return self._hedge is not None

    def attach_hedge(self, fut: ServeFuture) -> bool:
        """Adopt a fired hedge leg; False (and cancel it) if the race is
        already over or a hedge is already attached."""
        with self._lock:
            if self._event.is_set() or self._hedge is not None:
                adopted = False
            else:
                self._hedge = fut
                self._stats.record_hedge_fired()
                adopted = True
        if not adopted:
            fut.cancel()
            return False
        # Register OUTSIDE the wrapper lock: a hedge leg can resolve the
        # instant it is submitted (result-cache hit, coalesced join onto a
        # finishing leader), in which case add_done_callback invokes
        # _child_done synchronously on THIS thread — which must be able to
        # take the wrapper lock. If the primary wins the narrow window
        # before this line, _child_done sees the attached hedge as the
        # loser and cancels it as usual.
        fut.add_done_callback(self._child_done)
        return True

    def _child_done(self, child: ServeFuture) -> None:
        won_by_hedge = False
        loser: Optional[ServeFuture] = None
        with self._lock:
            if self._event.is_set():
                return                      # race already decided
            other = self._hedge if child is self._primary else self._primary
            if child._error is not None and other is not None \
                    and not other.done():
                # This leg failed but the other may still answer: hold the
                # wrapper open; the other leg's callback decides.
                return
            self._winner = child
            self.latency_ms = 1000.0 * (self._clock() - self.t_enqueue)
            self.model_version = child.model_version
            won_by_hedge = child is self._hedge and child._error is None
            loser = other
            self._event.set()
        if loser is not None and not loser.done():
            loser.cancel()
            self._stats.record_hedge_cancelled()
        if won_by_hedge:
            self._stats.record_hedge_won()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def cache_hit(self) -> bool:
        """True when the leg that WON the race was a cache hit."""
        winner = self._winner
        return (winner or self._primary).cache_hit

    @property
    def coalesced(self) -> bool:
        """True when the winning leg joined an in-flight leader."""
        winner = self._winner
        return (winner or self._primary).coalesced

    def cancelled(self) -> bool:
        return self._primary.cancelled()

    def cancel(self) -> bool:
        self._primary.cancel()
        with self._lock:
            hedge = self._hedge
        if hedge is not None:
            hedge.cancel()
        return not self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise ServeTimeout(
                f"hedged request of {self.n} rows unresolved after "
                f"{timeout}s")
        winner = self._winner
        if winner._error is not None:
            raise winner._error
        return winner._probs


class ReplicatedEngine:
    """N :class:`ServingEngine` replicas behind one submit() surface."""

    #: The frontend checks this to pass its client id as the sticky key.
    supports_affinity = True
    #: The experiment router checks this to bypass the result cache on the
    #: shadow lane (every replica engine honours ``bypass_cache``).
    supports_cache_bypass = True

    def __init__(self, engines: Sequence[ServingEngine], *,
                 swap_poll_secs: float = 0.0, hedge_ms: float = 0.0,
                 hedge_poll_secs: float = 0.002,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one replica engine")
        if hedge_ms < 0:
            raise ValueError(f"hedge_ms must be >= 0, got {hedge_ms}")
        self._engines = engines
        self.max_batch = min(e.max_batch for e in engines)
        self.small_rows = max(e.small_rows for e in engines)
        self._swap_poll = float(swap_poll_secs)
        self._clock = clock
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # Routing observability (tests + drill): how many requests each
        # replica admitted, and how many left their sticky replica.
        self.routed: List[int] = [0] * len(engines)
        self.spills = 0
        # Request hedging (0 disables; needs >= 2 replicas to have a
        # "somewhere else"). hedge_ms is the FLOOR of the hedge delay; the
        # effective delay tracks the fleet's recent p99 so hedges fire only
        # for genuine stragglers, not the median request.
        self.hedge_ms = float(hedge_ms)
        self._hedge_poll = float(hedge_poll_secs)
        self._hedge_enabled = self.hedge_ms > 0 and len(engines) > 1
        self._outstanding: List[HedgedFuture] = []
        self._recent_latencies: deque = deque(maxlen=512)
        self._coordinator: Optional[threading.Thread] = None
        self._hedger: Optional[threading.Thread] = None
        if start and self._swap_poll > 0 and any(
                e.watcher is not None for e in engines):
            self._coordinator = threading.Thread(
                target=self._run_coordinator, name="replica-swap-coordinator",
                daemon=True)
            self._coordinator.start()
        if start and self._hedge_enabled:
            self._hedger = threading.Thread(
                target=self._run_hedger, name="replica-hedge-monitor",
                daemon=True)
            self._hedger.start()

    # ------------------------------------------------------- construction
    @classmethod
    def serve_latest(cls, publish_dir: str, *, replicas: int = 2,
                     poll_secs: float = 2.0,
                     watcher_kw: Optional[dict] = None,
                     **kw: Any) -> "ReplicatedEngine":
        """``replicas`` engines, each following ``<publish_dir>/LATEST``
        through its OWN model slot, swaps staggered by the coordinator.

        Per-replica watchers are created with ``start=False`` — the
        coordinator thread here is the only poller, and its sequential
        walk IS the stagger. Engine kwargs (``max_batch``, ``inflight``,
        ``small_rows``, ``admission_kw``, ...) apply to every replica —
        ``admission_kw`` (not a shared ``admission`` instance) so each
        replica builds its OWN gate over its own queue. ``hedge_ms``
        enables request hedging across the fleet.
        """
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        hedge_ms = float(kw.pop("hedge_ms", 0.0))
        hedge_poll_secs = float(kw.pop("hedge_poll_secs", 0.002))
        wkw = dict(watcher_kw or {})
        wkw["start"] = False
        engines = [ServingEngine.serve_latest(
            publish_dir, poll_secs=poll_secs, watcher_kw=dict(wkw), **kw)
            for _ in range(replicas)]
        return cls(engines, swap_poll_secs=poll_secs, hedge_ms=hedge_ms,
                   hedge_poll_secs=hedge_poll_secs)

    # ------------------------------------------------------------ routing
    @property
    def engines(self) -> List[ServingEngine]:
        return list(self._engines)

    @property
    def replicas(self) -> int:
        return len(self._engines)

    @property
    def pending_rows(self) -> int:
        return sum(e.pending_rows for e in self._engines)

    def _next_attempt(self, affinity: Optional[int],
                      tried: List[int]) -> Optional[int]:
        """The next replica to try: the sticky home first (affinity mod N),
        then the least-loaded untried replica by pending rows — RE-READ at
        each attempt, not snapshotted once up front, so a burst of spills
        spreads across the fleet instead of piling onto whichever replica
        was least loaded at the instant the first spill was computed."""
        if affinity is not None:
            home = int(affinity) % len(self._engines)
            if home not in tried:
                return home
        remaining = [i for i in range(len(self._engines)) if i not in tried]
        if not remaining:
            return None
        return min(remaining,
                   key=lambda i: (self._engines[i].pending_rows, i))

    def submit(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
               affinity: Optional[int] = None,
               trace_id: Optional[int] = None,
               value: str = VALUE_DEFAULT,
               bypass_cache: bool = False) -> ServeFuture:
        """Route one request: sticky replica, spill on overload/shed, typed
        error only when EVERY replica refused (:class:`AdmissionShed` when
        every refusal was a shed — the fleet CHOSE to refuse this class —
        :class:`ServerOverloaded` otherwise). Malformed requests
        (ValueError) fail fast without re-routing — they would be rejected
        everywhere. With hedging enabled the returned future is a
        :class:`HedgedFuture` (same ``done()``/``result()`` surface)."""
        tried: List[int] = []
        home: Optional[int] = None
        last: Optional[Exception] = None
        all_sheds = True
        while True:
            idx = self._next_attempt(affinity, tried)
            if idx is None:
                break
            if home is None:
                home = idx
            tried.append(idx)
            try:
                fut = self._engines[idx].submit(feat_ids, feat_vals,
                                                trace_id=trace_id,
                                                value=value,
                                                bypass_cache=bypass_cache)
            except AdmissionShed as e:
                last = e
                continue
            except ServerOverloaded as e:
                last = e
                all_sheds = False
                continue
            with self._lock:
                self.routed[idx] += 1
                if affinity is not None and idx != home:
                    self.spills += 1
                    trace_lib.instant("serve.spill", replica=idx,
                                      home=home, trace_id=trace_id)
            if self._hedge_enabled:
                hedged = HedgedFuture(fut, home_idx=idx,
                                      stats=self._engines[idx].stats,
                                      clock=self._clock)
                with self._lock:
                    self._outstanding.append(hedged)
                return hedged
            return fut
        assert last is not None
        if all_sheds:
            raise AdmissionShed(
                f"all {len(self._engines)} replicas refused: {last}")
        raise ServerOverloaded(
            f"all {len(self._engines)} replicas refused: {last}")

    def predict(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
                timeout: Optional[float] = None,
                affinity: Optional[int] = None,
                trace_id: Optional[int] = None,
                value: str = VALUE_DEFAULT) -> np.ndarray:
        return self.submit(feat_ids, feat_vals, affinity=affinity,
                           trace_id=trace_id, value=value).result(timeout)

    # ------------------------------------------------------------- hedging
    def hedge_delay_s(self) -> float:
        """Current hedge trigger: max(hedge_ms floor, fleet p99 of recent
        completions) — p99-tracked so hedges chase genuine stragglers."""
        floor = self.hedge_ms / 1000.0
        with self._lock:
            recent = list(self._recent_latencies)
        if len(recent) >= 20:
            return max(floor, float(np.percentile(recent, 99)) / 1000.0)
        return floor

    def hedge_pass(self, now: Optional[float] = None) -> int:
        """One monitor scan (public so tests drive it deterministically):
        prune resolved wrappers into the latency window, fire a hedge for
        every wrapper pending past the delay; returns hedges fired."""
        now = self._clock() if now is None else now
        delay = self.hedge_delay_s()
        fired = 0
        with self._lock:
            outstanding = list(self._outstanding)
        for hf in outstanding:
            if hf.done() or hf.cancelled():
                with self._lock:
                    try:
                        self._outstanding.remove(hf)
                    except ValueError:
                        pass
                    if hf.latency_ms is not None:
                        self._recent_latencies.append(hf.latency_ms)
                continue
            if hf.hedged or now - hf.t_enqueue < delay:
                continue
            others = [i for i in range(len(self._engines))
                      if i != hf.home_idx]
            # Least-loaded re-snapshot at fire time, same rule as spill.
            idx = min(others,
                      key=lambda i: (self._engines[i].pending_rows, i))
            try:
                fut = self._engines[idx].submit(
                    hf._primary.ids, hf._primary.vals,
                    trace_id=hf.trace_id, value=hf.value,
                    bypass_cache=hf._primary.cache_bypass)
            except (AdmissionShed, ServerOverloaded):
                continue    # fleet too hot to hedge; retry next pass
            if hf.attach_hedge(fut):
                fired += 1
                trace_lib.instant("serve.hedge", replica=idx,
                                  home=hf.home_idx, trace_id=hf.trace_id,
                                  delay_ms=round(delay * 1000.0, 3))
        return fired

    def _run_hedger(self) -> None:
        while not self._stop.wait(self._hedge_poll):
            self.hedge_pass()

    # ------------------------------------------------------ staggered swap
    def check_swaps_once(self) -> int:
        """One sequential stagger pass over the fleet; returns how many
        replicas swapped. Each ``check_once`` finishes (load + prewarm +
        swap) before the next replica's begins — at most one replica is
        ever mid-swap."""
        swapped = 0
        for eng in self._engines:
            watcher = eng.watcher
            if watcher is None:
                continue
            try:
                if watcher.check_once():
                    swapped += 1
            except Exception:  # noqa: BLE001 — poll faults never kill serving
                eng.stats.record_watcher_error()
        return swapped

    def _run_coordinator(self) -> None:
        while not self._stop.wait(self._swap_poll):
            self.check_swaps_once()

    # -------------------------------------------------------------- stats
    def summary(self) -> Dict[str, Any]:
        """Fleet aggregate (true fleet percentiles, union-window QPS,
        worst-replica + per-replica blackout/watcher-error lists), plus
        the per-replica bucket-prewarm counts from the owned watchers
        (None for a replica serving a plain fn without one)."""
        out = aggregate_summary([e.stats for e in self._engines])
        out["prewarmed_buckets_per_replica"] = [
            getattr(e.watcher, "prewarmed_buckets", None)
            for e in self._engines]
        return out

    def replica_summaries(self) -> List[Dict[str, Any]]:
        return [e.stats.summary() for e in self._engines]

    # ---------------------------------------------------------- lifecycle
    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the swap coordinator, then drain-close every replica —
        every admitted future across the fleet resolves."""
        self._stop.set()
        if self._coordinator is not None:
            self._coordinator.join(timeout=timeout)
            self._coordinator = None
        if self._hedger is not None:
            self._hedger.join(timeout=timeout)
            self._hedger = None
        for eng in self._engines:
            eng.close(timeout=timeout)

    def __enter__(self) -> "ReplicatedEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
