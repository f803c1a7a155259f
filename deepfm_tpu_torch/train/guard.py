"""Training-runtime numerical guard, stall watchdog and health accounting
(port of ``deepfm_tpu.train.guard``).

* :class:`TrainHealth` -- thread-safe counters of every runtime fault the
  train loop survived (preemptions, non-finite skips, rollbacks, watchdog
  aborts, loss spikes, unreadable resume sidecars), merged into the train
  task's result.
* :class:`NonFiniteGuard` -- non-finite loss/param detection with the
  ``--on_nonfinite {abort,skip,rollback}`` policy and an advisory EMA
  z-score loss-spike detector. ``abort`` looks at the loss the fit loop
  already reads at its log cadence; ``skip`` drops the poisoned dispatch's
  update (the fit loop restores its pre-dispatch snapshot of the state);
  ``rollback`` asks the task driver (:class:`RollbackSignal`) to restore
  the last checkpoint and replay from its recorded offset. Skips and
  rollbacks share one budget, ``--max_rollbacks``.
* :class:`StallWatchdog` -- a monitor thread that aborts the process with
  a diagnostic dump when no dispatch completes within
  ``--dispatch_timeout_s``.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..obs import metrics as metrics_lib
from ..utils import preempt as preempt_lib

log = logging.getLogger(__name__)


class TrainHealth:
    """Thread-safe counters for runtime faults survived by the train loop."""

    COUNTERS = ("preemptions", "nonfinite_skips", "rollbacks",
                "watchdog_aborts", "loss_spikes", "resume_meta_corrupt")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.preemptions = 0          # preempt saves taken (then exit 42)
        self.nonfinite_skips = 0      # poisoned dispatch updates dropped
        self.rollbacks = 0            # checkpoint restores after non-finite
        self.watchdog_aborts = 0      # dispatch-timeout aborts fired
        self.loss_spikes = 0          # EMA z-score outliers (warned only)
        self.resume_meta_corrupt = 0  # unreadable resume sidecars tolerated
        self._dirty = False
        metrics_lib.auto_register("train_health", self)

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
            self._dirty = True

    def record_preemption(self) -> None:
        self._bump("preemptions")

    def record_nonfinite_skip(self) -> None:
        self._bump("nonfinite_skips")

    def record_rollback(self) -> None:
        self._bump("rollbacks")

    def record_watchdog_abort(self) -> None:
        self._bump("watchdog_aborts")

    def record_loss_spike(self) -> None:
        self._bump("loss_spikes")

    def record_resume_meta_corrupt(self) -> None:
        self._bump("resume_meta_corrupt")

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: int(getattr(self, k)) for k in self.COUNTERS}

    def summary(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.snapshot().items())

    def consume_dirty(self) -> bool:
        with self._lock:
            dirty, self._dirty = self._dirty, False
            return dirty


class NonFiniteError(RuntimeError):
    """A non-finite loss or parameter under ``on_nonfinite=abort``, or a
    spent skip/rollback budget. The message carries the step number."""


class RollbackSignal(Exception):
    """The fit loop asks for a checkpoint rollback; the train task driver
    catches it, restores the latest checkpoint and replays from its
    recorded resume offset."""

    def __init__(self, step: int, detail: str = ""):
        super().__init__(f"rollback requested at step {step}"
                         + (f": {detail}" if detail else ""))
        self.step = int(step)


POLICIES = ("abort", "skip", "rollback")


class NonFiniteGuard:
    """Non-finite detection plus the EMA z-score spike detector.

    ``observe(loss, step, params_bad=...)`` classifies one dispatch and
    returns ``"ok"``, ``"skip"`` or ``"rollback"``; under ``abort`` (or once
    the shared skip/rollback budget ``max_events`` is spent) it raises
    :class:`NonFiniteError` naming the step.

    ``skip`` and ``rollback`` must stop the poisoned state before the next
    dispatch uses it, so the fit loop reads the loss back once per dispatch
    (:attr:`per_dispatch`); ``abort`` rides the log-cadence read and costs
    nothing per dispatch. The spike detector is advisory: it warns and
    counts when ``|loss - ema| / std`` exceeds ``spike_zscore`` after
    ``spike_warmup`` observations, and never stops a run."""

    def __init__(self, policy: str = "abort", max_events: int = 3,
                 health: Optional[TrainHealth] = None,
                 spike_zscore: float = 0.0, spike_warmup: int = 20,
                 ema_alpha: float = 0.1):
        if policy not in POLICIES:
            raise ValueError(
                f"on_nonfinite must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.max_events = int(max_events)
        self.health = health if health is not None else TrainHealth()
        self.spike_zscore = float(spike_zscore)
        self.spike_warmup = int(spike_warmup)
        self._alpha = float(ema_alpha)
        self._events = 0
        self._ema = 0.0
        self._var = 0.0
        self._n_obs = 0

    @property
    def per_dispatch(self) -> bool:
        """True when the fit loop must read back and check every dispatch."""
        return self.policy in ("skip", "rollback")

    @property
    def events(self) -> int:
        return self._events

    @classmethod
    def from_config(cls, cfg: Any, health: Optional[TrainHealth] = None
                    ) -> "NonFiniteGuard":
        return cls(policy=cfg.on_nonfinite, max_events=cfg.max_rollbacks,
                   health=health, spike_zscore=cfg.loss_spike_zscore)

    @staticmethod
    def params_nonfinite(params: Dict[str, torch.Tensor]) -> bool:
        """True when any floating param holds a non-finite value (one
        device reduction and one read)."""
        flags = [torch.isfinite(p).all() for p in params.values()
                 if p.is_floating_point()]
        return bool(flags) and not bool(torch.stack(flags).all())

    def _observe_spike(self, loss: float, step: int) -> None:
        if self.spike_zscore <= 0.0:
            return
        self._n_obs += 1
        if self._n_obs == 1:
            self._ema = loss
            self._var = 0.0
            return
        dev = loss - self._ema
        if self._n_obs > self.spike_warmup:
            z = abs(dev) / math.sqrt(max(self._var, 1e-12))
            if z > self.spike_zscore:
                self.health.record_loss_spike()
                log.warning(
                    "loss spike at step %d: loss=%.5f is %.1f sigma from EMA "
                    "%.5f (threshold %s); continuing", step, loss, z,
                    self._ema, self.spike_zscore)
                return  # a spike must not poison its own baseline
        self._ema += self._alpha * dev
        self._var = (1 - self._alpha) * (self._var + self._alpha * dev * dev)

    def observe(self, loss: float, step: int, *,
                params_bad: bool = False) -> str:
        """Classify one completed dispatch: ``"ok"``, ``"skip"`` or
        ``"rollback"``; raises :class:`NonFiniteError` under abort or once
        the budget is spent. ``step`` is the global step after it."""
        if math.isfinite(loss) and not params_bad:
            self._observe_spike(loss, step)
            return "ok"
        what = (f"non-finite loss ({loss})" if not math.isfinite(loss)
                else "non-finite parameters")
        if self.policy == "abort":
            raise NonFiniteError(f"{what} at step {step} (on_nonfinite=abort)")
        self._events += 1
        if self._events > self.max_events:
            raise NonFiniteError(
                f"{what} at step {step}: non-finite budget exhausted "
                f"({self._events} events > max_rollbacks={self.max_events})")
        if self.policy == "skip":
            self.health.record_nonfinite_skip()
            log.warning("%s at step %d: dropping this dispatch's update "
                        "(on_nonfinite=skip, event %d/%d)", what, step,
                        self._events, self.max_events)
            return "skip"
        log.warning("%s at step %d: rolling back to the last checkpoint "
                    "(on_nonfinite=rollback, event %d/%d)", what, step,
                    self._events, self.max_events)
        return "rollback"


class StallWatchdog:
    """Abort with diagnostics when no dispatch completes within the timeout.

    The fit loop calls :meth:`beat` after every dispatch; a monitor thread
    checks the time since the last beat and, past ``timeout_s``, logs a
    dump (the step, the seconds since progress, the input source's health
    and the train health) and calls ``abort`` (by default
    ``os._exit(EXIT_WATCHDOG)``: a stalled dispatch usually blocks in native
    code, where an exception raised in a thread cannot land).

    A beat marks a dispatch enqueued on the card, not finished there; but
    the fit loop's staging ring fences each transfer on the dispatch
    ``staging_buffers`` earlier, so the host cannot run more than
    ``staging_buffers`` dispatches ahead of the card, and a dispatch that
    wedges on the card stops the beats as a stalled input source does.
    ``clock`` is injectable for sleep-free tests."""

    def __init__(self, timeout_s: float, *,
                 health: Optional[TrainHealth] = None,
                 data_health: Any = None,
                 abort: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 poll_s: Optional[float] = None,
                 name: str = "train"):
        self.timeout_s = float(timeout_s)
        self.health = health
        self._data_health = data_health
        self._abort = abort if abort is not None else self._default_abort
        self._clock = clock
        self._poll = (poll_s if poll_s is not None
                      else max(min(self.timeout_s / 4.0, 1.0), 0.01))
        self._name = name
        self._lock = threading.Lock()
        self._last = self._clock()
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @staticmethod
    def _default_abort(dump: str) -> None:  # noqa: ARG004
        os._exit(preempt_lib.EXIT_WATCHDOG)

    def beat(self, step: int) -> None:
        with self._lock:
            self._last = self._clock()
            self._step = int(step)

    def _dump(self, waited: float) -> str:
        lines = [f"stall watchdog ({self._name}): no dispatch completed in "
                 f"{waited:.1f}s (dispatch_timeout_s={self.timeout_s})",
                 f"  last progress: step {self._step}, {waited:.1f}s ago"]
        dh = self._data_health
        if dh is not None:
            try:
                lines.append(f"  data health: {dh.summary()}")
            except Exception:  # noqa: BLE001 (a dump must not fail)
                pass
        if self.health is not None:
            lines.append(f"  train health: {self.health.summary()}")
        return "\n".join(lines)

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                waited = self._clock() - self._last
            if waited >= self.timeout_s:
                self.fired = True
                if self.health is not None:
                    self.health.record_watchdog_abort()
                dump = self._dump(waited)
                log.error(dump)
                self._abort(dump)
                return

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"stall-watchdog-{self._name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
