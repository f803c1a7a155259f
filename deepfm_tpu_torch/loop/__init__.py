"""Closed-loop feedback layer: serve -> log -> delayed labels -> train shards
(the port's copy of ``deepfm_tpu.loop``).

The reference's production loop (impression logging, label attribution,
periodic retrains) lived outside the repo, in the ad platform; here it is an
owned subsystem so the whole serve->log->train->publish cycle can be drilled
as one system (``deepfm_tpu_torch.drills.production``):

  * :class:`~deepfm_tpu_torch.loop.impressions.ImpressionLogger` — served
    requests written back as TFRecord shards via atomic rename (the same
    write-then-``os.replace`` contract the online stream source expects of
    any producer).
  * :class:`~deepfm_tpu_torch.loop.join.DelayedLabelJoiner` — impressions
    joined with labels arriving on a delay distribution, emitted as training shards
    bit-identical in schema to ``generate_synthetic_ctr`` output; duplicate
    impressions, late labels, and labels past the join window are counted,
    never silently dropped (:class:`~deepfm_tpu_torch.loop.health.LoopHealth`).
  * :class:`~deepfm_tpu_torch.loop.skew.SkewChecker` — the training decoder
    and the serving feature path must produce bit-identical features for the
    same logged record (training/serving skew is the classic silent killer
    of online CTR systems).
  * :class:`~deepfm_tpu_torch.loop.traffic.DiurnalTrafficPlan` — a seeded,
    precomputed diurnal request plan with hidden-model ground-truth labels,
    so two drills with the same seed replay identical traffic.
  * :mod:`~deepfm_tpu_torch.loop.metrics` — windowed online-vs-frozen AUC and
    staleness percentiles for the drill's metrics plane.

Everything here is numpy + the pure-Python codec: no torch import, so the
feedback layer can run in light processes (loggers, joiners) that never
touch a device. Its host logic matches the JAX package's bit for bit.
"""

from .health import LoopHealth
from .impressions import ImpressionLogger, iter_impressions
from .join import DelayedLabelJoiner, SeededLabelFeed
from .metrics import arm_health, staleness_summary, windowed_auc
from .skew import SkewChecker
from .traffic import (DiurnalTrafficPlan, FloodTrafficPlan,
                      ZipfUserPopulation)

__all__ = [
    "DelayedLabelJoiner",
    "DiurnalTrafficPlan",
    "FloodTrafficPlan",
    "ImpressionLogger",
    "LoopHealth",
    "SeededLabelFeed",
    "SkewChecker",
    "ZipfUserPopulation",
    "arm_health",
    "iter_impressions",
    "staleness_summary",
    "windowed_auc",
]
