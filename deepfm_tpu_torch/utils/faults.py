"""Chaos seams of the port (its copy of the ``executor_slow``,
``cold_fetch``, NaN-batch, publish-crash and read-fault parts of
``deepfm_tpu.utils.faults``).

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
* Publishing: a test arms a one-shot crash at a named stage of the
  publish sequence (:func:`set_publish_crash`); the publisher raises
  :class:`InjectedFault` there (:func:`check_publish_crash`), as if the
  process died mid-publish.
* Input path: :class:`FlakyFS` installs itself as the fileio fault
  injector and fails scripted reads and opens, which the input path's
  retry must heal; ``DEEPFM_TPU_READ_FAULT_EVERY=k`` (the JAX package's
  variable) arms one for a whole process through
  :func:`install_env_faults`, which the train task calls at start.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Dict, Iterable, Optional, Tuple

from ..data import fileio


class InjectedFault(IOError):
    """Marker subclass so tests can tell injected faults from real ones.
    An IOError, so the default retryable classification applies."""


# -- publish crash seam ------------------------------------------------------
#
# One-shot: the publisher calls check_publish_crash at each stage
# ("before_rename", "after_rename_before_latest",
# "after_history_before_latest"); the armed stage raises once.

_publish_crash_lock = threading.Lock()
_publish_crash: Optional[str] = None


def set_publish_crash(stage: str) -> None:
    """Arm a one-shot crash at publish stage ``stage`` (taken once)."""
    global _publish_crash
    with _publish_crash_lock:
        _publish_crash = str(stage)


def check_publish_crash(stage: str) -> None:
    """Called by the publisher at each stage; raises iff armed for it."""
    global _publish_crash
    with _publish_crash_lock:
        if _publish_crash != stage:
            return
        _publish_crash = None
    raise InjectedFault(f"injected publish crash at stage {stage!r}")


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


READ_FAULT_ENV = "DEEPFM_TPU_READ_FAULT_EVERY"


def install_env_faults() -> Optional["FlakyFS"]:
    """Arm ``FlakyFS(read_fail_every=k)`` as the process's fileio injector
    when ``DEEPFM_TPU_READ_FAULT_EVERY=k`` (k > 0) is set; None otherwise."""
    every = int(os.environ.get(READ_FAULT_ENV, "0") or 0)
    if every <= 0:
        return None
    fs = FlakyFS(read_fail_every=every)
    fileio.set_fault_injector(fs)
    return fs


class FlakyStream(io.RawIOBase):
    """Read-stream wrapper raising scripted faults; otherwise transparent."""

    def __init__(self, fs: "FlakyFS", path: str, inner):
        super().__init__()
        self._fs = fs
        self._path = path
        self._inner = inner
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return bool(self._inner.seekable())

    def seek(self, offset: int, whence: int = 0) -> int:
        pos = self._inner.seek(offset, whence)
        self._pos = pos if pos is not None else offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        self._fs.maybe_fail_read(self._path, self._pos, n)
        chunk = self._inner.read(n)
        if chunk:
            self._pos += len(chunk)
        return chunk

    def close(self) -> None:
        try:
            self._inner.close()
        finally:
            super().close()


class FlakyFS:
    """Deterministic fault plan over the fileio layer.

    * ``read_fail_every=k``: every k-th ``read()`` call (counted across all
      streams, retry re-reads included) raises once; ``k=1`` fails every
      read, a permanent outage.
    * ``read_fail_offsets``: ``(path_substring, byte_offset)`` pairs; the
      first read on a matching stream that covers the offset raises, once
      per pair.
    * ``op_failures``: e.g. ``{"open": 1, "size": 2}``: the first N calls of
      that fileio op raise, one fault per call.

    A context manager; the ``injected_*`` counters let a test check that
    ``DataHealth`` reported exactly the injected faults.
    """

    def __init__(self, *, read_fail_every: int = 0,
                 read_fail_offsets: Iterable[Tuple[str, int]] = (),
                 op_failures: Optional[Dict[str, int]] = None):
        self.read_fail_every = int(read_fail_every)
        self._offset_plan = [(str(sub), int(off))
                             for sub, off in read_fail_offsets]
        self._offset_fired = [False] * len(self._offset_plan)
        self._op_remaining = dict(op_failures or {})
        self._lock = threading.Lock()
        self._read_calls = 0
        self.injected_read_faults = 0
        self.injected_op_faults = 0

    def on_op(self, op: str, path: str) -> None:
        with self._lock:
            left = self._op_remaining.get(op, 0)
            if left <= 0:
                return
            self._op_remaining[op] = left - 1
            self.injected_op_faults += 1
        raise InjectedFault(f"injected {op} fault on {path}")

    def wrap_stream(self, path: str, stream) -> FlakyStream:
        return FlakyStream(self, path, stream)

    def maybe_fail_read(self, path: str, pos: int, n: int) -> None:
        with self._lock:
            self._read_calls += 1
            idx = self._read_calls
            fail = (self.read_fail_every > 0
                    and idx % self.read_fail_every == 0)
            reason = f"read #{idx}"
            if not fail:
                end = pos + (n if n and n > 0 else 1)
                for i, (sub, off) in enumerate(self._offset_plan):
                    if (not self._offset_fired[i] and sub in path
                            and pos <= off < end):
                        self._offset_fired[i] = True
                        fail = True
                        reason = f"offset {off}"
                        break
            if fail:
                self.injected_read_faults += 1
        if fail:
            raise InjectedFault(
                f"injected transient read fault ({reason}) on {path} "
                f"at byte {pos}")

    def __enter__(self) -> "FlakyFS":
        fileio.set_fault_injector(self)
        return self

    def __exit__(self, *exc) -> None:
        fileio.set_fault_injector(None)
