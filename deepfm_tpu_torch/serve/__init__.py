"""Serving runtime (the port's copy of ``deepfm_tpu.serve``): dynamic
batching, bucketed shapes, hot swap.

  * :mod:`.stats` — thread-safe latency/QPS/occupancy/swap accounting.
  * :mod:`.admission` — SLO-aware admission gate and degradation ladder.
  * :mod:`.cache` — version-keyed LRU result cache and request fingerprint.
  * :mod:`.engine` — bounded queue, dynamic batcher, bucketed predict,
    response demux, hot swap via ``utils.export.LatestWatcher`` (torch is
    imported lazily at engine construction).

Replicas, the shared-memory frontend and the experiment router are not
ported yet (see ROADMAP.md).
"""

from .admission import (VALUE_CLASSES, VALUE_DEFAULT, AdmissionController,
                        AdmissionShed, DegradationLadder, HysteresisLadder)
from .cache import ResultCache, request_fingerprint
from .engine import ServeFuture, ServeTimeout, ServerOverloaded, ServingEngine
from .stats import ServingStats, aggregate_summary

__all__ = [
    "AdmissionController",
    "AdmissionShed",
    "DegradationLadder",
    "HysteresisLadder",
    "ResultCache",
    "ServeFuture",
    "ServeTimeout",
    "ServerOverloaded",
    "ServingEngine",
    "ServingStats",
    "VALUE_CLASSES",
    "VALUE_DEFAULT",
    "aggregate_summary",
    "request_fingerprint",
]
