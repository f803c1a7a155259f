"""Chaos seams of the port (its copy of the ``executor_slow`` and
``cold_fetch`` parts of ``deepfm_tpu.utils.faults``).

* Serving: a test or drill arms the next ``calls`` serving flushes to sleep
  ``delay_s`` each; the engine's executor consumes one armed delay per
  flush. That drives the degradation ladder without depending on host
  speed.
* Hot/cold tier: a test arms the next N cold-store fetches to raise
  :class:`InjectedFault`; the tier's fetch retry must heal them without
  corrupting the hot cache or the training trajectory.
"""

from __future__ import annotations

import threading


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
