"""Chaos seams of the port (its copy of the ``executor_slow``,
``cold_fetch`` and NaN-batch parts of ``deepfm_tpu.utils.faults``).

* Serving: a test or drill arms the next ``calls`` serving flushes to sleep
  ``delay_s`` each; the engine's executor consumes one armed delay per
  flush. That drives the degradation ladder without depending on host
  speed.
* Hot/cold tier: a test arms the next N cold-store fetches to raise
  :class:`InjectedFault`; the tier's fetch retry must heal them without
  corrupting the hot cache or the training trajectory.
* Training: a test arms a one-shot plan that poisons given batch indices
  of the next pipeline the train task builds with NaN
  (:func:`set_nan_plan`, :class:`BatchPoisoner`), which drives the
  non-finite guard's skip and rollback policies end to end.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple


class InjectedFault(IOError):
    """Marker subclass so tests can tell injected faults from real ones.
    An IOError, so the default retryable classification applies."""


_exec_slow_lock = threading.Lock()
_exec_slow_delay_s: float = 0.0
_exec_slow_calls: int = 0


def set_executor_slow(delay_s: float, calls: int) -> None:
    """Arm the next ``calls`` serving flushes to sleep ``delay_s`` each
    (0 calls disarms)."""
    global _exec_slow_delay_s, _exec_slow_calls
    with _exec_slow_lock:
        _exec_slow_delay_s = float(delay_s)
        _exec_slow_calls = int(calls)


def executor_slow_delay() -> float:
    """Consume one armed slow flush; returns the delay to sleep (0 when
    disarmed). Called by the engine's executor at every flush."""
    global _exec_slow_calls
    with _exec_slow_lock:
        if _exec_slow_calls <= 0:
            return 0.0
        _exec_slow_calls -= 1
        return _exec_slow_delay_s


def executor_slow_remaining() -> int:
    with _exec_slow_lock:
        return _exec_slow_calls


_cold_fetch_lock = threading.Lock()
_cold_fetch_fails: int = 0


def set_cold_fetch_plan(fail_count: int) -> None:
    """Arm the next ``fail_count`` cold-store fetches to raise (one fault
    per fetch call; the runtime's retry consumes them)."""
    global _cold_fetch_fails
    with _cold_fetch_lock:
        _cold_fetch_fails = int(fail_count)


def check_cold_fetch() -> None:
    """Called by the cold store at each fetch; raises while armed."""
    global _cold_fetch_fails
    with _cold_fetch_lock:
        if _cold_fetch_fails <= 0:
            return
        _cold_fetch_fails -= 1
    raise InjectedFault("injected cold-store fetch failure")


_nan_plan_lock = threading.Lock()
_nan_plan: Optional[Dict] = None


def set_nan_plan(batches: Iterable[int], *, value: float = float("nan"),
                 key: str = "feat_vals") -> None:
    """Arm a one-shot plan: poison these 0-based batch indices of the NEXT
    pipeline the train task builds (taken once, then cleared)."""
    global _nan_plan
    with _nan_plan_lock:
        _nan_plan = dict(batches=tuple(int(b) for b in batches),
                         value=float(value), key=str(key))


def take_nan_plan() -> Optional[Dict]:
    """Consume the armed plan (None when nothing is armed)."""
    global _nan_plan
    with _nan_plan_lock:
        plan, _nan_plan = _nan_plan, None
        return plan


class BatchPoisoner:
    """Pipeline wrapper that overwrites ``key`` of the planned batch indices
    with ``value`` (NaN by default). It exposes only ``__iter__`` and
    ``health``; batch indices count over the wrapper's lifetime."""

    def __init__(self, pipeline, *, batches: Tuple[int, ...],
                 value: float = float("nan"), key: str = "feat_vals"):
        self._pipeline = pipeline
        self._batches = frozenset(int(b) for b in batches)
        self._value = value
        self._key = key
        self.poisoned = 0

    @property
    def health(self):
        return getattr(self._pipeline, "health", None)

    def __iter__(self):
        for i, batch in enumerate(self._pipeline):
            if i in self._batches:
                batch = dict(batch)
                arr = batch[self._key].copy()
                arr[...] = self._value
                batch[self._key] = arr
                self.poisoned += 1
            yield batch
