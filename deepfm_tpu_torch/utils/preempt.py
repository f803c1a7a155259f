"""Preemption handling: signal listener and the graceful-exit contract
(port of ``deepfm_tpu.utils.preempt``).

A :class:`PreemptionListener` turns SIGTERM/SIGINT into a flag that the
train task polls once per dispatch. On the flag the in-flight dispatch
finishes, a checkpoint and the resume sidecar are force-saved (so the
mid-epoch resume is replay-exact), and the process exits with
:data:`EXIT_PREEMPTED`: a code of its own, so an orchestrator tells
"preempted, restart me" from "crashed, give up".

:meth:`PreemptionListener.trigger` is the injectable trigger: tests and
drills take the production code path without delivering real signals.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional, Tuple

log = logging.getLogger(__name__)

# Exit-code contract:
#   42 -- preempted: a checkpoint and the resume sidecar were saved;
#         restart to resume.
#   43 -- watchdog abort: no dispatch completed within --dispatch_timeout_s;
#         a restart MAY clear a transient stall (a wedged input source).
# Anything else is an ordinary crash that an orchestrator should not retry
# blindly.
EXIT_PREEMPTED = 42
EXIT_WATCHDOG = 43
RESTARTABLE_EXIT_CODES = frozenset({EXIT_PREEMPTED, EXIT_WATCHDOG})


class Preempted(Exception):
    """Raised by the train task after the preemption checkpoint landed.
    Carries the global step of the saved checkpoint; the launcher maps it to
    :data:`EXIT_PREEMPTED`."""

    def __init__(self, step: int, reason: str = ""):
        msg = f"preempted at step {step}"
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)
        self.step = int(step)
        self.reason = reason


class PreemptionListener:
    """SIGTERM/SIGINT -> flag, polled by the training loop.

    Signal handlers can only be installed from the main thread; elsewhere
    (a test driving ``tasks.run`` on a worker thread) the listener works in
    trigger-only mode, and :meth:`trigger` is the injectable seam either
    way. ``install``/``uninstall`` save and restore the prior handlers."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False
        self.reason = ""

    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
        # Signal context: set the flag and nothing else; the training loop
        # logs and saves at the next dispatch boundary.
        self.reason = f"signal {signum}"
        self._event.set()

    def trigger(self, reason: str = "injected") -> None:
        """Injectable trigger: the flag the signal handler sets."""
        self.reason = reason
        self._event.set()

    def triggered(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        """Reset the flag (tests reuse one process across phases)."""
        self.reason = ""
        self._event.clear()

    def install(self) -> "PreemptionListener":
        if self._installed:
            return self
        self._installed = True
        if threading.current_thread() is not threading.main_thread():
            log.info("preemption listener on a non-main thread: "
                     "trigger-only mode (no signal handlers)")
            return self
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionListener":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_LISTENER: Optional[PreemptionListener] = None
_LISTENER_LOCK = threading.Lock()


def get_listener() -> PreemptionListener:
    """The process-wide listener, installed on first use. A flag set before
    training starts is honored at the first dispatch (a notice during
    start-up is not lost), so tests that trigger it ``clear()`` between
    phases."""
    global _LISTENER
    with _LISTENER_LOCK:
        if _LISTENER is None:
            _LISTENER = PreemptionListener()
        return _LISTENER.install()
