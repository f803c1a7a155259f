"""Unbounded stream source: tail an ever-growing set of TFRecord shards
(the port's copy of ``deepfm_tpu.data.stream``).

The reference's Pipe-mode FIFO replays a *fixed* channel; ``--online_mode``
instead trains continuously from a directory (or manifest file) that keeps
receiving new shards.  :class:`UnboundedFileStream` presents the same
bounded-``read(n)`` byte-stream contract as ``ChainedFileStream``, so the
whole streaming decode path (``StreamingCtrPipeline`` → framer → bad-record
policy) consumes it unchanged; only the producer side knows the input never
ends.

Admission protocol (directory mode): every ``poll_secs`` the source is
globbed; a new file is *admitted* once its size is stable across two
consecutive polls (writers must write-once — create under a temp name and
rename, or finish writing before the second poll).  Manifest mode (``source``
is a text file of shard paths, one per line, appended over time) declares
files complete, so lines are admitted as soon as the named file exists.

Replay-exactness: every admission is appended — *before any of its bytes are
served* — to a high-water-mark sidecar (atomic via ``fileio.write_atomic``).
On restart the sidecar is replayed verbatim: same files, same order, same
per-file byte counts (each file is read exactly up to its admitted size, so
late growth never shifts record positions).  Combined with the consumer-side
``skip_batches`` trim this makes online resume consume each record exactly
once.  The watcher then resumes polling where the sidecar left off.

Anomalies are healed or skipped and counted in :class:`DataHealth`:

- **late** — a new file sorting before an already-admitted name (out-of-order
  delivery).  Admitted anyway; counted so operators can spot slow writers.
- **duplicate** — a new path whose basename was already admitted (the same
  shard re-delivered elsewhere).  Skipped; counted.
- **torn** — an admitted file that vanished or shrank before/while being
  read.  The remaining bytes are discarded and the stream moves on (the
  framer's carried tail then resyncs under the bad-record policy); counted,
  and the discarded bytes land in ``bytes_discarded``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

from . import fileio
from .health import DataHealth

_SIDECAR_VERSION = 1


class UnboundedFileStream:
    """Bounded-``read(n)`` view over a growing shard set, replayed exactly.

    ``read(n)`` returns up to ``n`` bytes; it returns *fewer* as soon as the
    currently-admitted files are drained (the framer treats any non-empty
    read as progress, so small fresh shards reach the trainer without
    waiting to fill a 64MB chunk) and returns ``b""`` — true EOF — only when
    :meth:`request_stop` was called or no new data arrived for
    ``idle_timeout_secs`` (0 = wait forever, i.e. run until signalled).
    """

    def __init__(self, source: str, *,
                 pattern: str = "*",
                 sidecar_path: str = "",
                 poll_secs: float = 2.0,
                 idle_timeout_secs: float = 0.0,
                 retry_policy=None,
                 health: Optional[DataHealth] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None):
        self._source = source
        self._pattern = pattern
        self._sidecar_path = sidecar_path
        self._poll_secs = float(poll_secs)
        self._idle_timeout_secs = float(idle_timeout_secs)
        self._retry_policy = retry_policy
        self.health = health if health is not None else DataHealth()
        self._clock = clock
        self._stop = threading.Event()
        # Default sleep rides the stop event so request_stop() interrupts a
        # poll wait immediately; tests inject a no-op for sleep-free polling.
        self._sleep = sleep if sleep is not None else self._stop.wait
        self._manifest_mode = bool(source) and not fileio.isdir(source)

        # Admission state. ``admitted`` is the full high-water-mark history
        # (mirrored in the sidecar); ``_queue``/``_qidx`` is the unread
        # suffix being served.
        self.admitted: List[Tuple[str, int]] = []
        self._queue: List[Tuple[str, int]] = []
        self._qidx = 0
        self._seen_paths: set = set()
        self._seen_names: set = set()
        self._max_name = ""
        self._pending: dict = {}  # path -> last observed size (settling)
        self._fh = None
        self._fh_path = ""
        self._fh_remaining = 0
        self._last_progress = self._clock()
        self._load_sidecar()

    # ---------------------------------------------------------------- sidecar

    def _load_sidecar(self) -> None:
        if not self._sidecar_path or not fileio.exists(self._sidecar_path):
            return
        try:
            with fileio.open_stream(self._sidecar_path, "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
            if meta.get("version") != _SIDECAR_VERSION:
                raise ValueError(f"sidecar version {meta.get('version')}")
            entries = [(str(p), int(s)) for p, s in meta["admitted"]]
        except Exception as e:  # corrupt sidecar: replay-exact resume is
            # impossible; start a fresh manifest rather than crash-loop.
            warnings.warn(
                f"stream sidecar {self._sidecar_path} unreadable ({e}); "
                "starting a fresh manifest — resume will not be replay-exact",
                RuntimeWarning, stacklevel=2)
            return
        if meta.get("source") not in (None, self._source):
            warnings.warn(
                f"stream sidecar {self._sidecar_path} was written for source "
                f"{meta.get('source')!r}, not {self._source!r}; ignoring it",
                RuntimeWarning, stacklevel=2)
            return
        for path, size in entries:
            self._note_admitted(path, size, count_late=False)

    def _write_sidecar(self) -> None:
        if not self._sidecar_path:
            return
        fileio.write_atomic(self._sidecar_path, json.dumps({
            "version": _SIDECAR_VERSION,
            "source": self._source,
            "pattern": self._pattern,
            "admitted": [[p, s] for p, s in self.admitted],
        }))

    # -------------------------------------------------------------- admission

    def _note_admitted(self, path: str, size: int, *,
                       count_late: bool = True) -> None:
        name = os.path.basename(path)
        if count_late and self._max_name and name < self._max_name:
            self.health.record_late_file(path)
        if name > self._max_name:
            self._max_name = name
        self._seen_paths.add(path)
        self._seen_names.add(name)
        entry = (path, int(size))
        self.admitted.append(entry)
        self._queue.append(entry)

    def _list_candidates(self) -> Sequence[Tuple[str, Optional[int]]]:
        """(path, declared_complete_size_or_None) for every current source
        entry. Directory mode returns None sizes (settling decides); manifest
        mode stats the named file (a listed-but-absent file stays pending)."""
        if self._manifest_mode:
            try:
                with fileio.open_stream(self._source, "rb") as f:
                    lines = f.read().decode("utf-8").splitlines()
            except OSError:
                return []
            out = []
            for line in lines:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                out.append((line, None))
            return out
        return [(p, None)
                for p in fileio.glob(fileio.join(self._source, self._pattern))]

    def _poll_once(self) -> bool:
        """One watcher pass; returns True iff new files were admitted.

        New files settle for one poll (size must be stable) in directory
        mode; manifest-declared files admit as soon as they exist non-empty.
        The sidecar is flushed BEFORE returning, so no byte of a new file is
        ever served ahead of its high-water-mark record.
        """
        admitted_any = False
        for path, _ in self._list_candidates():
            if path in self._seen_paths:
                continue
            name = os.path.basename(path)
            if name in self._seen_names:
                # Same shard re-delivered under another path: train on it
                # once, not twice.
                self.health.record_duplicate_file(path)
                self._seen_paths.add(path)
                continue
            try:
                if not fileio.exists(path):
                    continue
                size = fileio.size(path)
            except OSError:
                continue  # raced a writer; retry next poll
            if size <= 0:
                continue  # empty or still being created
            if self._manifest_mode or self._pending.get(path) == size:
                self._pending.pop(path, None)
                self._note_admitted(path, size)
                admitted_any = True
            else:
                self._pending[path] = size  # settle one more poll
        if admitted_any:
            self._write_sidecar()
            self._mark_progress()
        return admitted_any

    def poll_now(self) -> bool:
        """Force a watcher pass outside the read loop (tests, feeders)."""
        return self._poll_once()

    # ------------------------------------------------------------------ read

    def _mark_progress(self) -> None:
        self._last_progress = self._clock()

    def _open_current(self, path: str):
        on_retry = None
        health = self.health
        if health is not None:
            on_retry = lambda exc, n, p=path: health.record_retry(p)  # noqa: E731
        return fileio.open_resilient(path, policy=self._retry_policy,
                                     on_retry=on_retry)

    def _advance(self) -> bool:
        """Open the next admitted file; False when the queue is drained."""
        while self._qidx < len(self._queue):
            path, size = self._queue[self._qidx]
            self._qidx += 1
            try:
                if not fileio.exists(path):
                    # Admitted then vanished: the records it held cannot be
                    # replayed — count the tear and keep streaming.
                    self.health.record_torn_file(path, nbytes=size)
                    continue
            except OSError:
                self.health.record_torn_file(path, nbytes=size)
                continue
            self._fh = self._open_current(path)
            self._fh_path = path
            self._fh_remaining = size
            return True
        return False

    def _close_current(self) -> None:
        fh, self._fh = self._fh, None
        self._fh_path = ""
        self._fh_remaining = 0
        if fh is not None:
            try:
                fh.close()
            except Exception:
                pass

    def _wait_for_data(self) -> bool:
        """Block until new files are admitted (True) or the stream ends
        (False: stop requested, or idle past ``idle_timeout_secs``)."""
        while True:
            if self._stop.is_set():
                return False
            if self._poll_once():
                return True
            if self._stop.is_set():
                return False
            if (self._idle_timeout_secs > 0
                    and self._clock() - self._last_progress
                    >= self._idle_timeout_secs):
                return False
            self._sleep(self._poll_secs)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            raise ValueError(
                "UnboundedFileStream only supports bounded reads")
        out = []
        got = 0
        while got < n:
            if self._fh is None:
                if not self._advance():
                    if got:
                        break  # serve what we have; caller reads again
                    if not self._wait_for_data():
                        break  # true EOF: stopped or idle-timed-out
                    continue
            want = min(n - got, self._fh_remaining)
            if want == 0:
                # Admitted size fully delivered. Bytes appended after
                # admission are deliberately ignored (write-once contract):
                # replay must see the same per-file byte count.
                self._close_current()
                continue
            try:
                chunk = self._fh.read(want)
            except OSError:
                # Mid-read tear survived retries: discard the rest of this
                # file and let the framer resync under the bad-record policy.
                self.health.record_torn_file(
                    self._fh_path, nbytes=self._fh_remaining)
                self._close_current()
                continue
            if not chunk:
                # File shrank below its admitted size.
                self.health.record_torn_file(
                    self._fh_path, nbytes=self._fh_remaining)
                self._close_current()
                continue
            self._fh_remaining -= len(chunk)
            got += len(chunk)
            out.append(chunk)
            self._mark_progress()
        if len(out) == 1:
            return out[0]
        return b"".join(out)

    # ----------------------------------------------------------------- misc

    def request_stop(self) -> None:
        """Finish the current read promptly and report EOF thereafter.
        Called from the preemption path so a blocked poll wait wakes up."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def files_admitted(self) -> List[str]:
        return [p for p, _ in self.admitted]

    def close(self) -> None:
        self.request_stop()
        self._close_current()
