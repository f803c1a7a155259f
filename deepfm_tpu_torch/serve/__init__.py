"""Serving runtime (the port's copy of ``deepfm_tpu.serve``): dynamic
batching, bucketed shapes, hot swap, replicas, the shared-memory frontend
and the experiment router.

Layering (heaviest import last: clients can use :mod:`.frontend` and
:mod:`.stats` without loading torch):

  * :mod:`.stats` — thread-safe latency/QPS/occupancy/swap accounting.
  * :mod:`.admission` — SLO-aware admission gate and degradation ladder.
  * :mod:`.cache` — version-keyed LRU result cache and request fingerprint.
  * :mod:`.engine` — bounded queue, dynamic batcher, bucketed predict,
    response demux, hot swap via ``utils.export.LatestWatcher`` (torch is
    imported lazily at engine construction).
  * :mod:`.experiment` — traffic-split router (A/B, shadow, canary) with
    pure hash-split arm assignment, shadow-lane isolation and the canary
    kill-switch (pairs with ``train.promote`` for gated deployment).
  * :mod:`.replicas` — N engine replicas behind one submit surface: sticky
    client-affinity routing with least-loaded spill, hedging, staggered
    per-replica hot swap, fleet-aggregate stats. On one card the replicas
    share it.
  * :mod:`.frontend` — N client processes → one card-owning server over
    ``data.shm_ring`` slab rings, with the exit-43 wedge contract.
"""

from .admission import (VALUE_CLASSES, VALUE_DEFAULT, AdmissionController,
                        AdmissionShed, DegradationLadder, HysteresisLadder)
from .cache import ResultCache, request_fingerprint
from .engine import ServeFuture, ServeTimeout, ServerOverloaded, ServingEngine
from .experiment import (ARM_CHALLENGER, ARM_CONTROL, ExperimentRouter,
                         assign_arm)
from .frontend import (FrontendHandle, FrontendServer, ServingClient,
                       client_main)
from .replicas import HedgedFuture, ReplicatedEngine
from .stats import ServingStats, aggregate_summary

__all__ = [
    "ARM_CHALLENGER",
    "ARM_CONTROL",
    "AdmissionController",
    "AdmissionShed",
    "DegradationLadder",
    "ExperimentRouter",
    "FrontendHandle",
    "FrontendServer",
    "HedgedFuture",
    "HysteresisLadder",
    "ReplicatedEngine",
    "ResultCache",
    "ServeFuture",
    "ServeTimeout",
    "ServerOverloaded",
    "ServingClient",
    "ServingEngine",
    "ServingStats",
    "VALUE_CLASSES",
    "VALUE_DEFAULT",
    "aggregate_summary",
    "assign_arm",
    "client_main",
    "request_fingerprint",
]
