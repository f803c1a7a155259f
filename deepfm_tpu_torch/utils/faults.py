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
  retry must heal.
* Whole drills: :class:`ChaosSchedule` is one seeded, time-indexed plan of
  every kind above (and the ones a drill process executes itself),
  serialized to canonical JSON; ``DEEPFM_TPU_CHAOS_SCHEDULE`` (inline JSON
  or ``@path``) carries it into a process, and :func:`install_env_faults`,
  which the train task calls at start, arms it. The legacy
  ``DEEPFM_TPU_READ_FAULT_EVERY=k`` still works: it becomes a
  ``read_faults`` event of the schedule. Same seed and parameters give the
  same JSON and fingerprint as the JAX package's schedule.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import random
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

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


# Env-carried chaos, read by :func:`install_env_faults` (the variables are
# the JAX package's):
#   * DEEPFM_TPU_READ_FAULT_EVERY=k: the single-knob read-fault variable;
#     it becomes a read_faults event of the schedule.
#   * DEEPFM_TPU_CHAOS_SCHEDULE=<json|@path>: a serialized ChaosSchedule.
#   * DEEPFM_TPU_CHAOS_STATE=<path>: the one-shot guard across supervised
#     restarts (which one-shot events an earlier incarnation armed).
READ_FAULT_ENV = "DEEPFM_TPU_READ_FAULT_EVERY"
CHAOS_ENV = "DEEPFM_TPU_CHAOS_SCHEDULE"
CHAOS_STATE_ENV = "DEEPFM_TPU_CHAOS_STATE"

# The port's train task reads its step triggers under these names
# (``train/tasks.py``); the schedule's step kinds set them.
_STEP_TRIGGER_ENV = {
    "preempt_after_steps": "DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS",
    "fault_after_steps": "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS",
    "hold_after_steps": "DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS",
}


def install_env_faults() -> Optional["FlakyFS"]:
    """Arm the process's env-carried chaos (the schedule of
    ``DEEPFM_TPU_CHAOS_SCHEDULE`` merged with
    ``DEEPFM_TPU_READ_FAULT_EVERY``); returns the armed :class:`FlakyFS`,
    or None when nothing asks for read faults."""
    schedule = ChaosSchedule.from_env(os.environ)
    if schedule is None:
        return None
    return schedule.install(state_path=os.environ.get(CHAOS_STATE_ENV) or None)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: ``kind`` at ``at_s`` seconds from drill start.

    ``at_s`` is advisory for process-local kinds (they are armed at
    process start and fire at their seam's own trigger point); it is the
    firing time for the drill-side kinds, which the drill executes against
    its own clock."""

    at_s: float
    kind: str
    arg: Tuple[Tuple[str, Any], ...] = ()

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.arg:
            if k == key:
                return v
        return default

    @staticmethod
    def make(at_s: float, kind: str, **arg: Any) -> "ChaosEvent":
        return ChaosEvent(round(float(at_s), 3), str(kind),
                          tuple(sorted(arg.items())))


class ChaosSchedule:
    """Seeded, time-indexed fault plan over every injection seam.

    * ``generate(seed, ...)`` draws event times from ``random.Random(seed)``
      (the language pins its sequence), so the same call reproduces the
      same plan, and the same plan as the JAX package's ``generate``.
    * ``to_json()``/``from_json()`` round-trip it canonically (sorted keys,
      times rounded to 1 ms); ``fingerprint()`` hashes the JSON.
    * ``install()`` arms every PROCESS_KIND through its seam: read faults
      -> a :class:`FlakyFS`; ``publish_crash`` -> :func:`set_publish_crash`;
      ``cold_fetch`` -> :func:`set_cold_fetch_plan`; ``nan_batches`` ->
      :func:`set_nan_plan`; the step kinds -> the port's
      ``DEEPFM_TPU_TORCH_*_AFTER_STEPS`` variables, which the train task
      reads after :func:`install_env_faults`. One-shot kinds are guarded
      by ``state_path``, so a supervised restart does not re-arm them.
    * DRIVER_KINDS are executed by the drill process itself (:meth:`due`):
      a SIGTERM to the trainer, a slow serving executor, and the poisoned
      challengers of the experiment drill.
    """

    PROCESS_KINDS = ("read_faults", "publish_crash", "cold_fetch",
                     "nan_batches", "preempt_after_steps",
                     "fault_after_steps", "hold_after_steps")
    DRIVER_KINDS = ("preempt", "executor_slow", "challenger_nan",
                    "challenger_stale", "challenger_slow")
    #: kinds that must fire once per drill, not once per process start
    ONESHOT_KINDS = ("publish_crash", "cold_fetch", "nan_batches")
    KINDS = PROCESS_KINDS + DRIVER_KINDS

    def __init__(self, events: Iterable[ChaosEvent], *,
                 seed: Optional[int] = None):
        events = tuple(sorted(events, key=lambda e: e.at_s))
        for ev in events:
            if ev.kind not in self.KINDS:
                raise ValueError(
                    f"unknown chaos kind {ev.kind!r} (know {self.KINDS})")
        self.events = events
        self.seed = seed

    @classmethod
    def generate(cls, seed: int, *, horizon_s: float,
                 read_fault_every: int = 0,
                 publish_crashes: int = 0,
                 publish_crash_stage: str = "before_rename",
                 preemptions: int = 0,
                 cold_fetch_fails: int = 0,
                 nan_batches: int = 0,
                 executor_slow_events: int = 0,
                 executor_slow_ms: float = 0.0,
                 executor_slow_calls: int = 0,
                 challenger_nan_events: int = 0,
                 challenger_nan_batches: int = 3,
                 challenger_stale_events: int = 0,
                 challenger_slow_events: int = 0,
                 challenger_slow_ms: float = 0.0,
                 challenger_slow_calls: int = 0) -> "ChaosSchedule":
        """Draw a plan for a drill of ``horizon_s`` seconds. Event times
        land in the middle 20-80% of the horizon (the slow-executor window
        in 20-50%, so its recovery fits too). The draws come in the JAX
        package's order, kind by kind, so the plans are equal."""
        rng = random.Random(int(seed))
        events: List[ChaosEvent] = []
        if read_fault_every > 0:
            events.append(ChaosEvent.make(
                0.0, "read_faults", every=int(read_fault_every)))
        for _ in range(int(publish_crashes)):
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.8) * horizon_s, "publish_crash",
                stage=str(publish_crash_stage)))
        for _ in range(int(preemptions)):
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.8) * horizon_s, "preempt"))
        if cold_fetch_fails > 0:
            events.append(ChaosEvent.make(
                0.0, "cold_fetch", fails=int(cold_fetch_fails)))
        if nan_batches > 0:
            batches = sorted(rng.sample(range(2, 50), int(nan_batches)))
            events.append(ChaosEvent.make(
                0.0, "nan_batches", batches=tuple(batches)))
        for _ in range(int(executor_slow_events)):
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.5) * horizon_s, "executor_slow",
                delay_ms=round(float(executor_slow_ms), 3),
                calls=int(executor_slow_calls)))
        for _ in range(int(challenger_nan_events)):
            batches = sorted(rng.sample(range(0, 20),
                                        int(challenger_nan_batches)))
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.8) * horizon_s, "challenger_nan",
                batches=tuple(batches)))
        for _ in range(int(challenger_stale_events)):
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.8) * horizon_s, "challenger_stale"))
        for _ in range(int(challenger_slow_events)):
            events.append(ChaosEvent.make(
                rng.uniform(0.2, 0.8) * horizon_s, "challenger_slow",
                delay_ms=round(float(challenger_slow_ms), 3),
                calls=int(challenger_slow_calls)))
        return cls(events, seed=int(seed))

    # -- serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed,
             "events": [{"at_s": ev.at_s, "kind": ev.kind,
                         "arg": dict(ev.arg)} for ev in self.events]},
            sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "ChaosSchedule":
        spec = json.loads(text)
        events = []
        for ev in spec["events"]:
            arg = {k: (tuple(v) if isinstance(v, list) else v)
                   for k, v in ev.get("arg", {}).items()}
            events.append(ChaosEvent.make(ev["at_s"], ev["kind"], **arg))
        return cls(events, seed=spec.get("seed"))

    @classmethod
    def from_env(cls, environ) -> Optional["ChaosSchedule"]:
        """The schedule of ``CHAOS_ENV`` (inline JSON or ``@/path``) merged
        with ``READ_FAULT_ENV``, which becomes a ``read_faults`` event
        unless the schedule has one. None when neither asks for anything."""
        schedule = None
        spec = environ.get(CHAOS_ENV, "")
        if spec:
            if spec.startswith("@"):
                with open(spec[1:], encoding="utf-8") as f:
                    spec = f.read()
            schedule = cls.from_json(spec)
        every = int(environ.get(READ_FAULT_ENV, "0") or 0)
        if every > 0 and (schedule is None
                          or not schedule.events_of("read_faults")):
            events = schedule.events if schedule is not None else ()
            seed = schedule.seed if schedule is not None else None
            schedule = cls(
                events + (ChaosEvent.make(0.0, "read_faults", every=every),),
                seed=seed)
        return schedule

    def fingerprint(self) -> str:
        """Stable hex id of the exact plan (two runs with equal
        fingerprints replayed the same chaos)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]

    # -- queries --------------------------------------------------------
    def events_of(self, *kinds: str) -> Tuple[ChaosEvent, ...]:
        return tuple(ev for ev in self.events if ev.kind in kinds)

    def due(self, now_s: float, fired: set) -> List[ChaosEvent]:
        """Driver-side pump: DRIVER_KINDS events scheduled at or before
        ``now_s`` not yet in ``fired`` (which this call updates)."""
        out = []
        for i, ev in enumerate(self.events):
            if ev.kind in self.DRIVER_KINDS and i not in fired \
                    and ev.at_s <= now_s:
                fired.add(i)
                out.append(ev)
        return out

    # -- process-local arming -------------------------------------------
    def install(self, state_path: Optional[str] = None) -> Optional["FlakyFS"]:
        """Arm every process-local kind through its seam.

        Continuous kinds (read faults, step triggers) re-arm on every call:
        a restarted process lives in the same weather. ONESHOT_KINDS arm
        at most once per ``state_path`` (an atomically replaced JSON list
        of armed event keys), so one scheduled publish crash fires once
        per drill even across supervised restarts."""
        armed: List[str] = []
        if state_path and os.path.exists(state_path):
            with open(state_path, encoding="utf-8") as f:
                armed = json.load(f)
        newly: List[str] = []
        fs: Optional[FlakyFS] = None
        for i, ev in enumerate(self.events):
            key = f"{i}:{ev.kind}"
            if ev.kind in self.ONESHOT_KINDS and key in armed:
                continue
            if ev.kind == "read_faults":
                fs = FlakyFS(read_fail_every=int(ev.get("every", 0)))
                fileio.set_fault_injector(fs)
            elif ev.kind == "publish_crash":
                set_publish_crash(ev.get("stage", "before_rename"))
                newly.append(key)
            elif ev.kind == "cold_fetch":
                set_cold_fetch_plan(int(ev.get("fails", 0)))
                newly.append(key)
            elif ev.kind == "nan_batches":
                set_nan_plan(ev.get("batches", ()))
                newly.append(key)
            elif ev.kind in _STEP_TRIGGER_ENV:
                os.environ[_STEP_TRIGGER_ENV[ev.kind]] = str(
                    int(ev.get("steps", 0)))
        if newly and state_path:
            tmp = state_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(armed + newly, f)
            os.replace(tmp, state_path)
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
    * ``save_failures=n``: the first n ``CheckpointManager._do_save`` calls
      raise (patched while the context is active).

    A context manager; the ``injected_*`` counters let a test check that
    ``DataHealth`` reported exactly the injected faults.
    """

    def __init__(self, *, read_fail_every: int = 0,
                 read_fail_offsets: Iterable[Tuple[str, int]] = (),
                 op_failures: Optional[Dict[str, int]] = None,
                 save_failures: int = 0):
        self.read_fail_every = int(read_fail_every)
        self._offset_plan = [(str(sub), int(off))
                             for sub, off in read_fail_offsets]
        self._offset_fired = [False] * len(self._offset_plan)
        self._op_remaining = dict(op_failures or {})
        self._save_remaining = int(save_failures)
        self._lock = threading.Lock()
        self._read_calls = 0
        self.injected_read_faults = 0
        self.injected_op_faults = 0
        self.injected_save_faults = 0
        self._ckpt_patch = None  # (class, original _do_save) while active

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

    def _patch_checkpoint_saves(self) -> None:
        from . import checkpoint as ckpt_lib  # noqa: PLC0415 (imports torch)
        fs = self
        original = ckpt_lib.CheckpointManager._do_save

        def flaky_do_save(mgr, step, snapshot):
            with fs._lock:
                inject = fs._save_remaining > 0
                if inject:
                    fs._save_remaining -= 1
                    fs.injected_save_faults += 1
            if inject:
                raise InjectedFault(
                    f"injected checkpoint-save fault at step {step}")
            return original(mgr, step, snapshot)

        ckpt_lib.CheckpointManager._do_save = flaky_do_save
        self._ckpt_patch = (ckpt_lib.CheckpointManager, original)

    def __enter__(self) -> "FlakyFS":
        fileio.set_fault_injector(self)
        if self._save_remaining > 0:
            self._patch_checkpoint_saves()
        return self

    def __exit__(self, *exc) -> None:
        fileio.set_fault_injector(None)
        if self._ckpt_patch is not None:
            cls, original = self._ckpt_patch
            cls._do_save = original
            self._ckpt_patch = None
