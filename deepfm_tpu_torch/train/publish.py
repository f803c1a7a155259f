"""Atomic hot model publishing for the online trainer (port of
``deepfm_tpu.train.publish``).

An online trainer publishes servable artifacts *mid-training* without ever
exposing a half-written directory. :class:`Publisher` is a fit-loop hook:

  * **Cadence** — ``--publish_every_steps`` uses boundary-crossing
    arithmetic (like ``CheckpointManager.should_save``), so the publish
    *steps* are a function of the step sequence alone: a resumed run
    republishes the versions an uninterrupted run would. ``seed_cadence``
    anchors it at a restored step. ``--publish_every_secs`` adds a
    wall-clock cadence.
  * **Off the hot path** — the hook takes a host copy of the params and the
    model state on the fit thread: a completed device-to-host copy, since
    the steps update the state's tensors in place and the next dispatch
    would overwrite them. The export then runs on the
    :class:`~deepfm_tpu_torch.utils.checkpoint.AsyncSaveExecutor`'s thread
    from that copy alone, never from the live state. While a publish is in
    flight, due cadences are counted as skipped, not queued.
  * **Atomicity** — the artifact (``export_serving`` with ``step=``) is
    staged under a dot-prefixed directory in the publish dir, completed
    (marker written last), fsynced, then ``os.replace``d to its final
    ``<step>/`` name; only then does ``LATEST`` move, logged first to the
    pointer history and never backwards. A crash at any point leaves the
    previous artifact set intact or a complete new artifact, never a
    partly visible one. An ``extra_export`` hook writes further servables
    (the cascade's towers and index) into the staging dir before the
    ranker's export, so the one marker certifies every stage.
  * **Longevity** — :meth:`drain` lets the preemption path wait for an
    in-flight publish before exit 42; :meth:`check_wedged` (called every
    dispatch) trips the watchdog abort (exit 43) when a publish has been in
    flight longer than ``--publish_timeout_s``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data import fileio
from ..models import get_model
from ..obs import metrics as metrics_lib
from ..obs import trace as trace_lib
from ..utils import export as export_lib
from ..utils import faults as faults_lib
from ..utils import preempt as preempt_lib
from ..utils.checkpoint import AsyncSaveExecutor

log = logging.getLogger(__name__)


def _default_abort(detail: str) -> None:  # pragma: no cover - kills process
    log.warning("wedged publish: %s; aborting (exit %d)", detail,
                preempt_lib.EXIT_WATCHDOG)
    os._exit(preempt_lib.EXIT_WATCHDOG)


def _pct(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def host_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CPU copies of ``tensors``, complete when this returns (a blocking
    device-to-host copy per tensor)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class Publisher:
    """Fit-loop hook publishing servable artifacts on a step/time cadence."""

    def __init__(self, cfg: Config, publish_dir: str, *,
                 every_steps: int = 0, every_secs: float = 0.0,
                 timeout_s: float = 600.0,
                 executor: Optional[AsyncSaveExecutor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 abort: Optional[Callable[[str], None]] = None,
                 health=None,
                 extra_export: Optional[Callable[[str], None]] = None):
        self._cfg = cfg
        # Writes more servables into the staging dir before the ranker's
        # export, so its completion marker certifies them too (the
        # cascade's towers and index: ``rec.cascade.cascade_extra_export``).
        self._extra_export = extra_export
        self._dir = publish_dir
        self.every_steps = int(every_steps)
        self.every_secs = float(every_secs)
        self.timeout_s = float(timeout_s)
        self._executor = (executor if executor is not None
                          else AsyncSaveExecutor(name="publisher"))
        self._own_executor = executor is None
        self._clock = clock
        self._abort = abort if abort is not None else _default_abort
        self._health = health  # TrainHealth: watchdog_aborts
        fileio.makedirs(publish_dir)
        self._inflight = None          # Future of the running publish
        self._inflight_step = -1
        self._inflight_since = 0.0
        self._last_crossed_step = 0    # step-cadence boundary bookkeeping
        self._last_pub_time = clock()  # the time cadence anchors at start
        self._head_step = 0            # newest step seen (staleness)
        self.published: List[int] = []      # versions published
        self.publish_failures = 0
        self.skipped_inflight = 0           # due cadences hit while busy
        self.latencies_s: List[float] = []  # submit -> artifact visible
        self.staleness_steps: List[int] = []  # head - version at completion
        metrics_lib.auto_register("publisher", self)

    # ------------------------------------------------------------- cadence

    def seed_cadence(self, step: int) -> None:
        """Anchor the step cadence at a restored checkpoint step, so a
        resumed run crosses exactly the boundaries a fresh run would."""
        self._last_crossed_step = max(self._last_crossed_step, int(step))
        self._head_step = max(self._head_step, int(step))

    def _due(self, step: int) -> bool:
        if self.every_steps > 0 and (
                step // self.every_steps
                > self._last_crossed_step // self.every_steps):
            return True
        return (self.every_secs > 0
                and self._clock() - self._last_pub_time >= self.every_secs)

    def maybe_publish(self, state, step: int) -> bool:
        """Per-dispatch hook: snapshot and submit when a cadence is due.
        Never waits for I/O; True iff a publish was started."""
        step = int(step)
        self._head_step = max(self._head_step, step)
        self.check_wedged()
        if not self._due(step):
            return False
        if self._inflight is not None and not self._inflight.done():
            # Busy: drop this cadence rather than queue a stale snapshot.
            self.skipped_inflight += 1
            self._last_crossed_step = step
            return False
        self._reap()
        self._last_crossed_step = step
        self._last_pub_time = self._clock()
        self.publish_now(state, step)
        return True

    def publish_now(self, state, step: int) -> None:
        """Snapshot ``state`` at ``step`` and publish asynchronously."""
        with trace_lib.span("publish.snapshot", version=int(step)):
            params = host_copy(state.params)
            mstate = host_copy(state.model_state)
        self._inflight_step = int(step)
        self._inflight_since = self._clock()
        self._inflight = self._executor.submit(
            self._do_publish, params, mstate, int(step))

    # ------------------------------------------------------- background job

    def _do_publish(self, params: Dict[str, torch.Tensor],
                    mstate: Dict[str, torch.Tensor],
                    step: int) -> Optional[str]:
        version = str(step)
        final_dir = os.path.join(self._dir, version)
        if fileio.exists(os.path.join(final_dir, export_lib.COMPLETE_MARKER)):
            # Idempotent republish (a replay after a resume hits the same
            # cadence step): the bytes would be the same. LATEST still
            # advances, which heals a crash between rename and pointer.
            self._advance_latest(version)
            return final_dir
        staging = os.path.join(self._dir, f".staging-{version}-{os.getpid()}")
        if fileio.isdir(staging):
            fileio.rmtree(staging)
        model = get_model(self._cfg, device="meta")
        model.load_state_dict({**params, **mstate}, assign=True)
        with trace_lib.span("publish.stage", version=step):
            if self._extra_export is not None:
                self._extra_export(staging)
            export_lib.export_serving(model.eval(), self._cfg, staging,
                                      step=step)
            fileio.fsync_dir(staging)
        faults_lib.check_publish_crash("before_rename")
        with trace_lib.span("publish.rename", version=step):
            fileio.replace(staging, final_dir)
            fileio.fsync_dir(self._dir)
        faults_lib.check_publish_crash("after_rename_before_latest")
        with trace_lib.span("publish.pointer", version=step):
            self._advance_latest(version)
        return final_dir

    def _advance_latest(self, version: str) -> None:
        """Move LATEST forward, never backwards. Every move is appended to
        the pointer history BEFORE the pointer write; the append dedups its
        tail, so a crash between the two heals on the retried publish."""
        current = export_lib.read_latest(self._dir)
        if current is not None:
            try:
                if int(os.path.basename(current)) >= int(version):
                    return
            except ValueError:
                pass  # a non-numeric pointer is overwritten
        export_lib.append_pointer_event(self._dir, version, "publish")
        faults_lib.check_publish_crash("after_history_before_latest")
        export_lib.write_latest(self._dir, version)

    def history(self) -> List[Dict[str, Any]]:
        """The publish dir's pointer history, oldest first."""
        return export_lib.pointer_history(self._dir)

    # ------------------------------------------------------------ lifecycle

    def _reap(self) -> None:
        """Collect the finished in-flight job's outcome into the stats."""
        fut, self._inflight = self._inflight, None
        if fut is None:
            return
        step, since = self._inflight_step, self._inflight_since
        self._inflight_step = -1
        try:
            result = fut.result(timeout=0)
        except Exception as e:
            self.publish_failures += 1
            log.warning("publish of step %d failed (%s); the previous "
                        "artifact stays live; retrying next cadence", step, e)
            return
        if result is not None:
            self.published.append(step)
            self.latencies_s.append(self._clock() - since)
            self.staleness_steps.append(max(0, self._head_step - step))

    def check_wedged(self) -> None:
        """Trip the watchdog when a publish exceeds ``timeout_s`` in flight."""
        if self._inflight is None:
            return
        if self._inflight.done():
            self._reap()
            return
        elapsed = self._clock() - self._inflight_since
        if self.timeout_s > 0 and elapsed > self.timeout_s:
            if self._health is not None:
                self._health.record_watchdog_abort()
            self._abort(
                f"publish of step {self._inflight_step} in flight for "
                f"{elapsed:.1f}s (publish_timeout_s={self.timeout_s})")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for the in-flight publish (preemption, run end). True iff
        nothing was pending or it completed within ``timeout``."""
        fut = self._inflight
        if fut is None:
            return True
        try:
            fut.result(timeout=timeout)
        except Exception:
            pass  # accounted by _reap below
        if fut.done():
            self._reap()
            return True
        log.warning("publish of step %d still in flight after %ss drain",
                    self._inflight_step, timeout)
        return False

    def close(self) -> None:
        self.drain(timeout=self.timeout_s if self.timeout_s > 0 else None)
        if self._own_executor:
            self._executor.close()

    def stats(self) -> Dict[str, Any]:
        return {
            "published_versions": list(self.published),
            "publish_count": len(self.published),
            "publish_failures": self.publish_failures,
            "publish_skipped_inflight": self.skipped_inflight,
            "publish_latency_p50_s": _pct(self.latencies_s, 50),
            "publish_latency_p99_s": _pct(self.latencies_s, 99),
            "publish_latencies_s": list(self.latencies_s),
            "publish_staleness_steps_max": (
                max(self.staleness_steps) if self.staleness_steps else None),
        }
