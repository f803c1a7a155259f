"""Chaos seam for the serving executor (the port's copy of the
``executor_slow`` part of ``deepfm_tpu.utils.faults``).

A test or drill arms the next ``calls`` serving flushes to sleep
``delay_s`` each; the engine's executor consumes one armed delay per flush.
That drives the degradation ladder without depending on host speed.
"""

from __future__ import annotations

import threading

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
