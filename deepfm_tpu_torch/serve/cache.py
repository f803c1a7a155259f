"""Serving fast path: version-keyed result cache + request fingerprints.

The flood harness shows a heavy Zipf head of repeat users, yet every
request — even an identical concurrent duplicate — pays the full predict
path. This module is the read-through layer the engine puts in front of
the batcher:

  * :func:`request_fingerprint` — a content hash of one request's
    ``(ids, vals)`` arrays (shape + dtype + bytes), the identity under
    which "the same request" is defined for both caching and in-flight
    coalescing. Pure bytes, no float tolerance: two requests either ARE
    byte-identical or they are different requests.
  * :class:`ResultCache` — a thread-safe LRU keyed by
    ``(model_version, fingerprint)`` with row-denominated capacity and an
    optional TTL. Keying on the version that EXECUTED the flush makes hot
    swaps invalidate for free: post-swap lookups use the new version and
    simply miss, and the stale entries age out of the LRU tail. Values are
    stored and returned as copies, so a hit is bit-identical to the flush
    that produced it and no caller can mutate a cached response.

Cache hit/miss/coalesce COUNTERS live in
:class:`~deepfm_tpu_torch.serve.stats.ServingStats` (the engine's metric
surface); this module only counts its own internal evictions/expiries.
No torch import — same light-plane contract as ``stats.py``/``admission.py``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


def request_fingerprint(feat_ids: np.ndarray,
                        feat_vals: np.ndarray) -> bytes:
    """Content identity of one request: shape + dtype + raw bytes of both
    arrays, blake2b-compressed. Deterministic across processes (no Python
    hash randomization) so a replayed drill fingerprints identically."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(feat_ids.shape).encode())
    h.update(str(feat_ids.dtype).encode())
    h.update(np.ascontiguousarray(feat_ids).tobytes())
    h.update(str(feat_vals.dtype).encode())
    h.update(np.ascontiguousarray(feat_vals).tobytes())
    return h.digest()


def _copy_value(value: Any) -> Any:
    """Deep-enough copy of a demuxed response (``[n]`` array or the
    multitask ``{task: [n]}`` dict) — bit-identical, never aliased."""
    if isinstance(value, dict):
        return {k: np.array(v, copy=True) for k, v in value.items()}
    return np.array(value, copy=True)


class ResultCache:
    """LRU of ``(model_version, fingerprint) -> response`` in ROW units.

    ``rows`` bounds the total cached response rows (the same unit the
    request queue is bounded in); inserting past it evicts from the LRU
    tail. ``ttl_s`` > 0 expires entries on lookup (lazily — an expired
    entry costs nothing until it is next touched). All clock reads come
    from the injectable ``clock`` so TTL tests are sleep-free.
    """

    def __init__(self, rows: int, *, ttl_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if rows < 1:
            raise ValueError(f"cache rows must be >= 1, got {rows}")
        if ttl_s < 0:
            raise ValueError(f"cache ttl_s must be >= 0, got {ttl_s}")
        self.capacity_rows = int(rows)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (version, fp) -> (value, rows, inserted_at); LRU order, most
        # recently used last.
        self._entries: "OrderedDict[Tuple[Any, bytes], Tuple[Any, int, float]]" = OrderedDict()
        self._rows = 0
        self.evictions = 0      # capacity evictions (LRU tail)
        self.expirations = 0    # TTL expiries seen at lookup/insert

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    def _expired(self, inserted_at: float, now: float) -> bool:
        return self.ttl_s > 0 and (now - inserted_at) > self.ttl_s

    def get(self, version: Any, fingerprint: bytes) -> Optional[Any]:
        """The cached response for this exact request under this exact
        model version, or None. A hit refreshes LRU recency and returns a
        COPY (bit-identical to the stored flush output)."""
        key = (version, fingerprint)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            value, n, at = entry
            if self._expired(at, self._clock()):
                del self._entries[key]
                self._rows -= n
                self.expirations += 1
                return None
            self._entries.move_to_end(key)
            return _copy_value(value)

    def put(self, version: Any, fingerprint: bytes, value: Any,
            rows: int) -> None:
        """Insert (a copy of) one response; evicts LRU entries until the
        row budget holds. An over-budget single response is simply not
        cached (never evict the whole cache for one giant request)."""
        n = int(rows)
        if n > self.capacity_rows:
            return
        key = (version, fingerprint)
        stored = _copy_value(value)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._rows -= old[1]
            while self._rows + n > self.capacity_rows and self._entries:
                _, (_, old_n, _) = self._entries.popitem(last=False)
                self._rows -= old_n
                self.evictions += 1
            self._entries[key] = (stored, n, self._clock())
            self._rows += n

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache_entries": len(self._entries),
                "cache_rows_used": self._rows,
                "cache_capacity_rows": self.capacity_rows,
                "cache_ttl_s": self.ttl_s,
                "cache_evictions": self.evictions,
                "cache_expirations": self.expirations,
            }
