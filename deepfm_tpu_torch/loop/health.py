"""Feedback-loop health accounting, mirroring ``data.health.DataHealth``.

One thread-safe object the impression logger and the delayed-label joiner
both stamp into; ``snapshot()`` is what the production drill writes into
``PRODUCTION_r0N.json``. Counters are typed (one name per failure mode) so
a drill can assert *exactly* how many duplicates/late/past-window events
occurred — "some labels were dropped" is not an auditable statement.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..obs import metrics as metrics_lib

SCALAR_COUNTERS = (
    "impressions_logged",       # rows written to impression shards
    "impression_shards",        # impression shards atomically published
    "duplicate_impressions",    # same impression id logged again (dropped)
    "labels_joined",            # label arrived within the join window
    "labels_past_window",       # label arrived after the window (dropped,
                                # impression already emitted as unlabeled)
    "labels_late",              # label for an unknown or already-labeled
                                # impression (duplicate/orphan label)
    "impressions_expired",      # emitted with the no-label default after
                                # the window closed (delayed-feedback
                                # negatives; late positives land in
                                # labels_past_window)
    "torn_impression_shards",   # truncated shard healed mid-join (intact
                                # prefix processed, tail discarded)
    "joined_shards",            # training shards atomically emitted
    "records_emitted",          # rows in emitted training shards
)


class LoopHealth:
    """Thread-safe counters for the serve->log->join->train feedback loop."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for name in SCALAR_COUNTERS:
            setattr(self, name, 0)
        metrics_lib.auto_register("loop_health", self)

    def record(self, counter: str, n: int = 1) -> None:
        if counter not in SCALAR_COUNTERS:
            raise ValueError(f"unknown loop counter {counter!r}")
        with self._lock:
            setattr(self, counter, getattr(self, counter) + int(n))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: int(getattr(self, k)) for k in SCALAR_COUNTERS}

    def merge_into(self, totals: Dict[str, int]) -> None:
        snap = self.snapshot()
        for key in SCALAR_COUNTERS:
            totals[key] = totals.get(key, 0) + snap[key]

    def summary(self) -> str:
        snap = self.snapshot()
        return " ".join(f"{k}={v}" for k, v in snap.items() if v)
