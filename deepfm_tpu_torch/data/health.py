"""Data-plane health accounting: bad-record policy + per-file fault stats
(the port's copy of ``deepfm_tpu.data.health``).

:class:`BadRecordPolicy` decides raise-vs-skip for corrupt/truncated frames
(with a skip budget), and :class:`DataHealth` aggregates per-file skip and
retry counters so the training loop can log them every ``log_steps`` and at
epoch end. Thread-safe — the pooled decode path and the prefetch thread both
report into the same object.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..obs import metrics as metrics_lib

SCALAR_COUNTERS = ("read_retries", "bad_records", "truncated_tails",
                   "bytes_discarded", "late_files", "duplicate_files",
                   "torn_files")


class DataHealth:
    """Thread-safe counters for I/O faults survived by the pipeline."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.read_retries = 0        # transient read errors healed by retry
        self.bad_records = 0         # corrupt records skipped
        self.truncated_tails = 0     # files whose tail was discarded
        self.bytes_discarded = 0     # payload bytes dropped with bad frames
        # Unbounded-stream-source counters (data/stream.py): shards that
        # arrived sorting before already-consumed ones (admitted anyway),
        # shards whose name was already consumed (skipped), and shards that
        # vanished or shrank mid-read (partial tail discarded, stream heals).
        self.late_files = 0
        self.duplicate_files = 0
        self.torn_files = 0
        self.per_file: Dict[str, Dict[str, int]] = {}
        self._dirty = False
        # Unified registry (obs.metrics): snapshot() is the metric surface.
        metrics_lib.auto_register("data_health", self)

    def _file(self, path: str) -> Dict[str, int]:
        entry = self.per_file.get(path)
        if entry is None:
            entry = {"retries": 0, "skipped": 0}
            self.per_file[path] = entry
        return entry

    def record_retry(self, path: str) -> None:
        with self._lock:
            self.read_retries += 1
            self._file(path)["retries"] += 1
            self._dirty = True

    def record_bad_record(self, path: str, nbytes: int = 0, *,
                          truncated: bool = False) -> None:
        with self._lock:
            self.bad_records += 1
            self.bytes_discarded += int(nbytes)
            if truncated:
                self.truncated_tails += 1
            self._file(path)["skipped"] += 1
            self._dirty = True

    def record_late_file(self, path: str) -> None:
        with self._lock:
            self.late_files += 1
            self._dirty = True

    def record_duplicate_file(self, path: str) -> None:
        with self._lock:
            self.duplicate_files += 1
            self._dirty = True

    def record_torn_file(self, path: str, nbytes: int = 0) -> None:
        with self._lock:
            self.torn_files += 1
            self.bytes_discarded += int(nbytes)
            self._file(path)["skipped"] += 1
            self._dirty = True

    @property
    def total_events(self) -> int:
        with self._lock:
            return self.read_retries + self.bad_records

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {k: getattr(self, k)
                                      for k in SCALAR_COUNTERS}
            out["per_file"] = {k: dict(v) for k, v in self.per_file.items()}
            return out

    def apply_delta(self, delta: Dict[str, object]) -> None:
        """Add a snapshot-shaped increment into these counters — the
        cross-process merge used by the input service (workers send
        cumulative snapshots; the parent applies successive differences,
        so restransmission-free aggregation stays exact)."""
        with self._lock:
            changed = False
            for key in SCALAR_COUNTERS:
                inc = int(delta.get(key, 0))  # type: ignore[arg-type]
                if inc:
                    setattr(self, key, getattr(self, key) + inc)
                    changed = True
            for path, c in delta.get("per_file", {}).items():  # type: ignore[union-attr]
                entry = self._file(path)
                for k in ("retries", "skipped"):
                    entry[k] += int(c.get(k, 0))
                changed = changed or any(c.values())
            self._dirty = self._dirty or changed

    def merge_into(self, totals: Dict[str, int]) -> None:
        """Accumulate scalar counters into ``totals`` (for cross-epoch sums)."""
        snap = self.snapshot()
        for key in SCALAR_COUNTERS:
            totals[key] = totals.get(key, 0) + int(snap[key])  # type: ignore[arg-type]

    def summary(self) -> str:
        snap = self.snapshot()
        worst = sorted(
            snap["per_file"].items(),  # type: ignore[union-attr]
            key=lambda kv: -(kv[1]["retries"] + kv[1]["skipped"]))[:3]
        files = ", ".join(
            f"{p}(retries={c['retries']},skipped={c['skipped']})"
            for p, c in worst)
        scalars = " ".join(f"{k}={snap[k]}" for k in SCALAR_COUNTERS
                           if k in ("read_retries", "bad_records",
                                    "truncated_tails", "bytes_discarded")
                           or snap[k])
        return scalars + (f" [{files}]" if files else "")

    def consume_dirty(self) -> bool:
        """True once per batch of new events — drives log_steps-cadence logs."""
        with self._lock:
            dirty, self._dirty = self._dirty, False
            return dirty


class BadRecordPolicy:
    """raise|skip decision for corrupt or truncated TFRecord frames.

    ``skip`` mode drops the offending record (or file tail, when framing can
    no longer resync) and counts it in :class:`DataHealth`; ``max_bad`` > 0
    bounds the total skips (budget exceeded → raise so a systemically
    corrupt dataset cannot silently train on a fraction of the data).
    ``max_bad == 0`` means unlimited.
    """

    def __init__(self, on_bad: str = "raise", max_bad: int = 0,
                 health: Optional[DataHealth] = None):
        if on_bad not in ("raise", "skip"):
            raise ValueError(
                f"on_bad_record must be 'raise' or 'skip', got {on_bad!r}")
        self.on_bad = on_bad
        self.max_bad = int(max_bad)
        self.health = health if health is not None else DataHealth()
        self._lock = threading.Lock()
        self._skipped = 0

    @property
    def skips(self) -> int:
        return self._skipped

    def bad_record(self, path: str, offset: int, reason: str, *,
                   nbytes: int = 0, truncated: bool = False) -> None:
        """Handle one bad frame at absolute byte ``offset`` of ``path``.

        Returns normally iff policy is skip and the budget allows; the
        caller then drops the frame and continues.
        """
        label = path or "<stream>"
        if self.on_bad != "skip":
            raise IOError(
                f"corrupt TFRecord: {reason} in {label} at byte {offset}")
        with self._lock:
            self._skipped += 1
            over_budget = self.max_bad > 0 and self._skipped > self.max_bad
        if over_budget:
            raise IOError(
                f"bad-record budget exceeded ({self._skipped} > "
                f"max_bad_records={self.max_bad}); last: {reason} in "
                f"{label} at byte {offset}")
        self.health.record_bad_record(label, nbytes, truncated=truncated)
