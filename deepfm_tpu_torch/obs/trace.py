"""Near-zero-overhead span tracing, exported as Chrome ``trace_event`` JSON.

One process-global :class:`Tracer` records span events into a preallocated
ring (``--trace ring``; wraparound overwrites the oldest events and COUNTS
them — never a silent loss) or an unbounded list (``--trace full``). Off
(the default) every instrumentation site costs one attribute load and a
falsy check: ``span()`` returns a shared no-op singleton, ``begin()``
returns ``None``, and no event object is ever built.

Three event shapes, all Perfetto/chrome://tracing loadable:

- ``span("name", **attrs)`` — a ``with``-block producing one complete
  ("X") event on the calling thread; nesting reconstructs from ts/dur
  containment per (pid, tid).
- ``begin("name", **attrs)`` / ``end(handle, **attrs)`` — an async
  ("b"/"e") pair sharing an id, for spans that start on one thread and
  finish on another (ring waits, executor handoffs).
- ``instant("name", **attrs)`` — a point ("i") event (spills, swaps).

The clock is ``time.time_ns()`` (wall), NOT ``perf_counter_ns``: traces
from several processes (trainer, input workers, drill) merge into ONE
timeline, so timestamps must share an epoch.

Device time: ``span("name", device=d)`` on a card (``d`` a CUDA device)
also records a CUDA event on the current stream at enter and at exit
(none while the stream is capturing a graph), and the event gains
``args.dev_ts``/``args.dev_dur`` (µs): when the card ran the span's
work, on the same wall clock as ``ts``. The two clocks meet at one
anchor per tracer, taken at its first device-timed span (synchronize,
then read ``time.time_ns()`` around an event's record and wait); later
spans are read against the end of the last outermost device span
resolved at least a second after the previous reference, so CUDA's
float32 milliseconds stay exact to ~0.1 µs however long the run. A pair
resolves once its end event has completed (checked at each device span's
exit), and at :func:`export` at the latest; a ``ring`` tracer holds at
most ``capacity`` unresolved pairs and waits for the oldest beyond that.
Spans of one stream nest by their device intervals whatever thread
opened them (autograd runs backward functions on a thread of its own).
On the CPU, or with ``device=None``, a span is a host span.
:func:`add_counts` hands the innermost open device span of the calling
thread a function of counts that only the card's finished work can give
(the take backward's long runs); the tracer calls it when the span
resolves and adds what it returns to the span's args.
:func:`device_mark` and :func:`elapsed_ms` are the program's one device
timer (the training loop's collective and dispatch timings use them
too).

Correlation ids: :func:`new_trace_id` mints process-unique int ids
(``pid << 20 | counter``) that ride request paths as plain ints — they
work even when tracing is off, so flag-off call sites need no branches.

Child processes inherit the configuration through ``DEEPFM_TPU_TRACE*``
env vars (set by :func:`configure`, read by :func:`configure_from_env`);
each process exports its own ``trace-<pid>.json`` and :func:`merge`
concatenates them into one file.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

MODES = ("off", "ring", "full")
DEFAULT_CAPACITY = 65536

ENV_MODE = "DEEPFM_TPU_TRACE"
ENV_DIR = "DEEPFM_TPU_TRACE_DIR"
ENV_BUFFER = "DEEPFM_TPU_TRACE_BUFFER"

#: How far (ms) a device span may start from the clock's reference before
#: the reference moves up: float32 milliseconds hold ~0.06 µs there.
_REANCHOR_MS = 1000.0
#: Readings of the host clock around an anchor event; the narrowest wins.
ANCHOR_TRIES = 5


def _on_card(device: Any) -> bool:
    return device is not None and str(device).startswith("cuda")


def device_mark(device: Any) -> Any:
    """A timing mark: on a card, a CUDA event recorded on the current
    stream; elsewhere the host clock (``time.perf_counter()``)."""
    if _on_card(device):
        import torch  # noqa: PLC0415 (a card implies torch is loaded)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _anchor(device: Any) -> Tuple[Any, float]:
    """An event the idle card ran and the wall time it ran at, in µs: the
    midpoint of the host clock's readings around its record and wait.
    The events are made and recorded once beforehand (the first record
    creates the CUDA event, tens of µs), and the narrowest of
    ``ANCHOR_TRIES`` readings is kept."""
    import torch  # noqa: PLC0415
    torch.cuda.synchronize(device)
    events = [device_mark(device) for _ in range(ANCHOR_TRIES)]
    torch.cuda.synchronize(device)
    best = None
    for ev in events:
        t0 = time.time_ns()
        ev.record()
        ev.synchronize()
        t1 = time.time_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, ev, (t0 + t1) / 2e3)
    return best[1], best[2]


def elapsed_ms(a: Any, b: Any) -> float:
    """Milliseconds from mark ``a`` to mark ``b`` of :func:`device_mark`
    (CUDA events: both must have completed)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return float(a.elapsed_time(b))


class _NullSpan:
    """Shared no-op span: what ``span()`` hands out when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_device", "_e0",
                 "_counts")

    def __init__(self, tracer: "Tracer", name: str, args: Dict,
                 device: Any = None):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0
        self._device = device
        self._e0 = None
        self._counts: List[Callable[[], Dict[str, int]]] = []

    def __enter__(self) -> "_Span":
        if self._device is not None:
            self._e0 = self._tracer._device_enter(self._device)
        self._tracer._open_spans().append(self)
        self._t0 = time.time_ns()
        return self

    def add(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. rows after batching)."""
        self._args.update(attrs)
        return self

    def __exit__(self, *exc) -> bool:
        e1 = device_mark(self._device) if self._e0 is not None else None
        t1 = time.time_ns()
        self._tracer._open_spans().pop()
        ev = {"name": self._name, "ph": "X", "ts": self._t0 / 1e3,
              "dur": (t1 - self._t0) / 1e3, "pid": os.getpid(),
              "tid": threading.get_ident()}
        if self._args or e1 is not None:
            ev["args"] = self._args
        self._tracer._emit(ev)
        if e1 is not None:
            self._tracer._device_exit(ev, self._e0, e1, self._counts)
        return False


class Tracer:
    """Ring- or list-buffered span recorder. Thread-safe; one per process."""

    def __init__(self, mode: str = "off",
                 capacity: int = DEFAULT_CAPACITY) -> None:
        if mode not in MODES:
            raise ValueError(f"trace mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._buf: List[Dict] = []
        self._head = 0          # ring overwrite cursor (oldest event)
        self.dropped = 0        # ring wraparound overwrites, counted
        self._ids = itertools.count(1)
        # Device spans: the clock's reference (event, wall µs), the open
        # spans, and the closed pairs not resolved yet (event, start and
        # end marks, outermost), in the order they closed.
        self._ref: Optional[Tuple[Any, float]] = None
        self._open = 0
        self._pending: collections.deque = collections.deque()
        self._local = threading.local()  # each thread's open spans

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def _emit(self, ev: Dict) -> None:
        with self._lock:
            if self.mode == "ring" and len(self._buf) >= self.capacity:
                self._buf[self._head] = ev
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1
            else:
                self._buf.append(ev)

    def span(self, name: str, device: Any = None,
             **attrs) -> Union[_Span, _NullSpan]:
        if self.mode == "off":
            return _NULL
        return _Span(self, name, attrs, device if _on_card(device) else None)

    def _open_spans(self) -> List[_Span]:
        stack = getattr(self._local, "spans", None)
        if stack is None:
            stack = self._local.spans = []
        return stack

    def add_counts(self, fn: Callable[[], Dict[str, int]]) -> bool:
        """Give ``fn`` to the innermost open device-timed span of this
        thread; False (and ``fn`` is never called) where there is none."""
        if self.mode == "off":
            return False
        for sp in reversed(self._open_spans()):
            if sp._e0 is not None:
                sp._counts.append(fn)
                return True
        return False

    # -- device spans ------------------------------------------------------
    def _device_enter(self, device: Any) -> Any:
        """The span's start mark, after the clock's anchor on first use;
        None while the current stream captures a graph (no sync there)."""
        import torch  # noqa: PLC0415
        if torch.cuda.is_current_stream_capturing():
            return None
        with self._lock:
            if self._ref is None:
                self._ref = _anchor(device)
            self._open += 1
        return device_mark(device)

    def _device_exit(self, ev: Dict, e0: Any, e1: Any,
                     counts: List[Callable[[], Dict[str, int]]]) -> None:
        with self._lock:
            self._open -= 1
            self._pending.append((ev, e0, e1, self._open == 0, counts))
            self._settle(int(self.mode == "ring"
                             and len(self._pending) > self.capacity))

    def _settle(self, wait: int = 0) -> None:
        """Resolve closed pairs oldest first: those whose end has
        completed, after waiting for the first ``wait``; each adds the
        counts it was given to its args. Holds the lock."""
        while self._pending:
            ev, e0, e1, outer, counts = self._pending[0]
            if wait > 0:
                e1.synchronize()
                wait -= 1
            elif not e1.query():
                return
            self._pending.popleft()
            ref, ref_us = self._ref
            ms = elapsed_ms(ref, e0)
            args = ev["args"]
            args["dev_ts"] = ref_us + ms * 1e3
            args["dev_dur"] = elapsed_ms(e0, e1) * 1e3
            for fn in counts:
                for k, v in fn().items():
                    args[k] = args.get(k, 0) + v
            if outer and ms >= _REANCHOR_MS:
                # Nothing unresolved started before this span's end.
                self._ref = (e1, args["dev_ts"] + args["dev_dur"])

    def begin(self, name: str, **attrs) -> Optional[Tuple[str, int]]:
        """Open an async span; finish it with :meth:`end` from ANY thread.
        Returns an opaque handle (None when tracing is off)."""
        if self.mode == "off":
            return None
        hid = next(self._ids)
        ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "b",
              "id": hid, "ts": time.time_ns() / 1e3, "pid": os.getpid(),
              "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)
        return (name, hid)

    def end(self, handle: Optional[Tuple[str, int]], **attrs) -> None:
        if handle is None:
            return
        name, hid = handle
        ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "e",
              "id": hid, "ts": time.time_ns() / 1e3, "pid": os.getpid(),
              "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def instant(self, name: str, **attrs) -> None:
        if self.mode == "off":
            return
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.time_ns() / 1e3, "pid": os.getpid(),
              "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def settle_all(self) -> None:
        """Resolve every closed device pair, waiting for the card."""
        with self._lock:
            self._settle(len(self._pending))

    def events(self) -> List[Dict]:
        """Chronological snapshot (ring order unrolled oldest-first)."""
        with self._lock:
            if self.mode == "ring" and len(self._buf) >= self.capacity:
                return self._buf[self._head:] + self._buf[:self._head]
            return list(self._buf)


# --------------------------------------------------------------------------
# Process-global tracer + module-level API (what call sites import).
# --------------------------------------------------------------------------

_tracer = Tracer()
_trace_dir = ""
_id_counter = itertools.count(1)


def configure(mode: str, *, capacity: int = DEFAULT_CAPACITY,
              trace_dir: str = "", export_env: bool = True) -> None:
    """Install the process-global tracer. With ``export_env`` (default) the
    settings also land in ``DEEPFM_TPU_TRACE*`` so spawned child processes
    (input workers, drill trainer) inherit them via
    :func:`configure_from_env`."""
    global _tracer, _trace_dir
    _tracer = Tracer(mode, capacity)
    _trace_dir = trace_dir or ""
    if export_env:
        os.environ[ENV_MODE] = mode
        os.environ[ENV_BUFFER] = str(int(capacity))
        if trace_dir:
            os.environ[ENV_DIR] = trace_dir
        else:
            os.environ.pop(ENV_DIR, None)


def configure_from_env() -> None:
    """Child-process entry: adopt the parent's trace settings (no-op when
    the parent never configured tracing)."""
    mode = os.environ.get(ENV_MODE, "off")
    if mode == "off":
        return
    try:
        capacity = int(os.environ.get(ENV_BUFFER, DEFAULT_CAPACITY))
    except ValueError:
        capacity = DEFAULT_CAPACITY
    configure(mode, capacity=capacity,
              trace_dir=os.environ.get(ENV_DIR, ""), export_env=False)


def reset() -> None:
    """Back to off + empty buffers (tests)."""
    global _tracer, _trace_dir
    _tracer = Tracer()
    _trace_dir = ""
    for k in (ENV_MODE, ENV_DIR, ENV_BUFFER):
        os.environ.pop(k, None)


def enabled() -> bool:
    return _tracer.enabled


def span(name: str, device: Any = None,
         **attrs) -> Union[_Span, _NullSpan]:
    """A host span; device-timed too where ``device`` is a card."""
    return _tracer.span(name, device, **attrs)


def add_counts(fn: Callable[[], Dict[str, int]]) -> bool:
    """Counts for the innermost open device-timed span of this thread:
    ``fn`` is called once the span's work has run on the card (when the
    span resolves, at :func:`export` at the latest), and each count it
    returns is added to the span's args (summed over several calls). False
    where tracing is off or no such span is open: ``fn`` is never called."""
    return _tracer.add_counts(fn)


def begin(name: str, **attrs) -> Optional[Tuple[str, int]]:
    return _tracer.begin(name, **attrs)


def end(handle: Optional[Tuple[str, int]], **attrs) -> None:
    _tracer.end(handle, **attrs)


def instant(name: str, **attrs) -> None:
    _tracer.instant(name, **attrs)


def dropped() -> int:
    return _tracer.dropped


def new_trace_id() -> int:
    """Mint a correlation id unique across the processes of one run
    (pid-tagged). Works with tracing off — call sites never branch."""
    return (os.getpid() << 20) | (next(_id_counter) & 0xFFFFF)


def export(path: Optional[str] = None) -> Optional[str]:
    """Write this process's events as a Chrome trace JSON; returns the path
    (None when tracing is off). Default path: ``<trace_dir>/trace-<pid>.json``."""
    if not _tracer.enabled:
        return None
    pid = os.getpid()
    if path is None:
        d = _trace_dir or "."
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"trace-{pid}.json")
    _tracer.settle_all()
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": f"deepfm_tpu_torch[{pid}]"}}]
    events.extend(_tracer.events())
    doc = {"traceEvents": events,
           "otherData": {"pid": pid, "mode": _tracer.mode,
                         "dropped_spans": _tracer.dropped}}
    tmp = f"{path}.tmp-{pid}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def merge(src: Union[str, Iterable[str]], out: str) -> str:
    """Concatenate per-process trace files (a directory of
    ``trace-*.json`` or an explicit path list) into one loadable trace;
    per-process drop counts are summed into ``otherData``."""
    if isinstance(src, str):
        paths = sorted(
            os.path.join(src, f) for f in os.listdir(src)
            if f.startswith("trace-") and f.endswith(".json"))
    else:
        paths = list(src)
    events: List[Dict] = []
    total_dropped = 0
    pids: List[int] = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        events.extend(doc.get("traceEvents", []))
        other = doc.get("otherData", {})
        total_dropped += int(other.get("dropped_spans", 0))
        if "pid" in other:
            pids.append(int(other["pid"]))
    doc = {"traceEvents": events,
           "otherData": {"merged_from": len(paths), "pids": pids,
                         "dropped_spans": total_dropped}}
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    return out
