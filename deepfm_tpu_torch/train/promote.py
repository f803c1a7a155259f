"""Guardrail-gated promotion: the controller that turns publish into
prove-promote-or-rollback (the port's copy of ``deepfm_tpu.train.promote``).

The :class:`~deepfm_tpu_torch.train.publish.Publisher` makes artifacts atomic;
this module makes them *earned*. A candidate version is ``offer()``-ed, its
per-arm online health (``loop.metrics.arm_health`` windows, computed from
the impression log + joiner) is ``observe()``-d window by window, and the
controller advances the serving ``LATEST`` pointer only after the candidate
passes EVERY gate for ``windows_required`` consecutive windows. One breach
demotes it (typed reason, counted, span-traced, pointer history appended);
a version that fails twice is quarantined and refuses further candidacy.

Every pointer move rides the same append-then-move protocol as the
Publisher (``export.append_pointer_event`` → crash seam → ``write_latest``),
so the whole deployment story — publish, promote, rollback, quarantine — is
replayable from ``pointer_history.jsonl`` alone, and a crash between the
history append and the pointer move heals idempotently on retry.

Gate evaluation is a pure function (:func:`evaluate_gates`) over two plain
metric dicts, so tests and the bench series drive it without any serving
stack behind it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import metrics as metrics_lib
from ..obs import trace as trace_lib
from ..utils import export as export_lib
from ..utils import faults as faults_lib

# Typed breach reasons — the vocabulary the audit sidecar, the counters, and
# the drill's assertions share. Strings, not an enum, so they serialize
# into history lines and reports untouched.
REASON_NONFINITE = "nonfinite_predictions"
REASON_AUC = "auc_regression"
REASON_LATENCY = "latency_p99"
REASON_CALIBRATION = "calibration_drift"
REASON_STALE = "stale_candidate"
REASON_QUARANTINED = "quarantined"
#: Hold (not breach) reason: the window is too thin to judge either way.
REASON_SAMPLES = "insufficient_samples"

BREACH_REASONS = (REASON_NONFINITE, REASON_AUC, REASON_LATENCY,
                  REASON_CALIBRATION, REASON_STALE)

#: How many gate breaches quarantine a candidate version for good.
QUARANTINE_FAILURES = 2


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """Promotion guardrails.

    ``min_samples`` gates the *judgment*, not the candidate: a thinner
    window is a hold. ``min_auc_delta`` is challenger-minus-control (a
    small negative tolerance absorbs window noise); ``max_p99_ratio``
    bounds challenger p99 as a multiple of control p99, and
    ``max_p99_ms`` > 0 adds an ABSOLUTE p99 ceiling on top (the ratio
    judges relative regressions, the ceiling judges "too slow to serve,
    period" — a sleeping challenger breaches it no matter how noisy the
    control's own tail was); ``max_nonfinite`` is an absolute count
    (default 0: one NaN is a breach); ``max_calibration_err`` bounds
    |mean predicted − observed CTR|; ``max_candidate_age_s`` > 0 adds
    the staleness gate (a frozen candidate that stops refreshing
    breaches on age alone)."""

    min_samples: int = 50
    min_auc_delta: float = -0.02
    max_p99_ratio: float = 1.5
    max_p99_ms: float = 0.0
    max_nonfinite: int = 0
    max_calibration_err: float = 0.2
    max_candidate_age_s: float = 0.0
    windows_required: int = 2

    def __post_init__(self):
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")
        if self.max_p99_ratio <= 0:
            raise ValueError(
                f"max_p99_ratio must be > 0, got {self.max_p99_ratio}")
        if self.max_p99_ms < 0:
            raise ValueError(
                f"max_p99_ms must be >= 0, got {self.max_p99_ms}")
        if self.max_nonfinite < 0:
            raise ValueError(
                f"max_nonfinite must be >= 0, got {self.max_nonfinite}")
        if self.max_calibration_err < 0:
            raise ValueError(f"max_calibration_err must be >= 0, got "
                             f"{self.max_calibration_err}")
        if self.max_candidate_age_s < 0:
            raise ValueError(f"max_candidate_age_s must be >= 0, got "
                             f"{self.max_candidate_age_s}")
        if self.windows_required < 1:
            raise ValueError(
                f"windows_required must be >= 1, got {self.windows_required}")

    @classmethod
    def from_config(cls, cfg) -> "GateConfig":
        """Build from the ``--experiment_*`` flags
        (``deepfm_tpu_torch.config``)."""
        return cls(
            min_samples=cfg.experiment_min_samples,
            min_auc_delta=cfg.experiment_min_auc_delta,
            max_p99_ratio=cfg.experiment_max_p99_ratio,
            max_p99_ms=cfg.experiment_max_p99_ms,
            max_nonfinite=cfg.experiment_max_nonfinite,
            max_calibration_err=cfg.experiment_max_calibration_err,
            max_candidate_age_s=cfg.experiment_max_candidate_age_s,
            windows_required=cfg.experiment_gate_windows)


def _finite(x: Any) -> bool:
    return x is not None and isinstance(x, (int, float)) \
        and math.isfinite(float(x))


def evaluate_gates(challenger: Dict[str, Any], control: Dict[str, Any],
                   gates: GateConfig, *,
                   candidate_age_s: float = 0.0
                   ) -> Tuple[bool, List[str], List[str]]:
    """Judge one health window: ``(passed, breaches, holds)``.

    ``challenger`` / ``control`` are per-arm dicts from
    ``loop.metrics.arm_health`` (keys ``n``, ``auc``, ``p99_latency_ms``,
    ``nonfinite``, ``calibration_err``). Breaches are typed reasons (the
    candidate is bad); holds mean the window cannot judge (too thin, or a
    one-class AUC) — a hold neither advances nor demotes. Gates whose
    inputs are unavailable on one side (e.g. no control p99) are skipped
    rather than guessed; the nonfinite gate never skips, because a NaN
    prediction is evidence all by itself."""
    breaches: List[str] = []
    holds: List[str] = []
    if int(challenger.get("nonfinite", 0)) > gates.max_nonfinite:
        breaches.append(REASON_NONFINITE)
    if gates.max_candidate_age_s > 0 \
            and candidate_age_s > gates.max_candidate_age_s:
        breaches.append(REASON_STALE)
    if int(challenger.get("n", 0)) < gates.min_samples:
        holds.append(REASON_SAMPLES)
        return (False, breaches, holds)
    c_auc, b_auc = challenger.get("auc"), control.get("auc")
    if _finite(c_auc) and _finite(b_auc):
        if float(c_auc) - float(b_auc) < gates.min_auc_delta:
            breaches.append(REASON_AUC)
    c_p99, b_p99 = challenger.get("p99_latency_ms"), \
        control.get("p99_latency_ms")
    if _finite(c_p99) and _finite(b_p99) and float(b_p99) > 0:
        if float(c_p99) > gates.max_p99_ratio * float(b_p99):
            breaches.append(REASON_LATENCY)
    if gates.max_p99_ms > 0 and _finite(c_p99) \
            and float(c_p99) > gates.max_p99_ms \
            and REASON_LATENCY not in breaches:
        breaches.append(REASON_LATENCY)
    cal = challenger.get("calibration_err")
    if _finite(cal) and float(cal) > gates.max_calibration_err:
        breaches.append(REASON_CALIBRATION)
    return (not breaches, breaches, holds)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One ``observe()`` outcome. ``action`` ∈ hold | pass | promote |
    rollback | quarantine (quarantine implies the rollback already
    happened); ``reasons`` are the typed breach/hold reasons that drove
    it; ``version`` is the candidate it concerns."""
    action: str
    version: Optional[str]
    reasons: Tuple[str, ...] = ()


class PromotionController:
    """Advance / demote the serving pointer on windowed per-arm health.

    One controller owns one publish dir's deployment state: the stable
    version (what LATEST points at between experiments), at most one
    candidate under evaluation, per-version failure counts, and the
    quarantine set. All pointer moves go through the audited
    append-then-move protocol; ``on_rollback`` is the kill-switch hook
    (the drill wires it to ``ExperimentRouter.kill``) and fires BEFORE the
    pointer moves back, so traffic stops reaching the bad arm first.
    """

    def __init__(self, publish_dir: str, *, gates: GateConfig,
                 stable_version: Optional[str] = None,
                 on_rollback: Optional[Callable[[str, str], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_time: Optional[Callable[[], float]] = None):
        self._dir = publish_dir
        self.gates = gates
        self._on_rollback = on_rollback
        self._clock = clock
        self._wall_time = wall_time
        if stable_version is None:
            current = export_lib.read_latest(publish_dir)
            if current is None:
                raise ValueError(
                    f"no stable_version given and {publish_dir} has no "
                    f"LATEST pointer yet")
            stable_version = os.path.basename(current)
        self.stable_version = str(stable_version)
        self.candidate: Optional[str] = None
        self._candidate_since: Optional[float] = None
        self.passing_windows = 0
        self.failures: Dict[str, int] = {}
        self.quarantined: set = set()
        # Counters (the controller's metric surface).
        self.promotions = 0
        self.rollbacks = 0
        self.quarantines = 0
        self.offers_refused = 0
        self.windows_observed = 0
        self.holds = 0
        self.breaches_by_reason: Dict[str, int] = {}
        metrics_lib.auto_register("promotion", self)

    # -------------------------------------------------------------- offers
    def offer(self, version: str, *, now_s: Optional[float] = None) -> bool:
        """Register ``version`` as the candidate under evaluation. False
        (and counted) when it is quarantined or already stable — the caller
        must not route traffic to a refused candidate."""
        version = str(version)
        if version in self.quarantined or version == self.stable_version:
            self.offers_refused += 1
            trace_lib.instant("promote.offer_refused", version=version,
                              reason=(REASON_QUARANTINED
                                      if version in self.quarantined
                                      else "already_stable"))
            return False
        self.candidate = version
        self._candidate_since = self._clock() if now_s is None else now_s
        self.passing_windows = 0
        trace_lib.instant("promote.offer", version=version)
        return True

    def candidate_age_s(self, now_s: Optional[float] = None) -> float:
        if self._candidate_since is None:
            return 0.0
        now = self._clock() if now_s is None else now_s
        return max(0.0, now - self._candidate_since)

    # ------------------------------------------------------------- observe
    def observe(self, challenger: Dict[str, Any], control: Dict[str, Any],
                *, now_s: Optional[float] = None) -> Decision:
        """Feed one completed health window; returns the typed decision and
        performs any pointer move it implies."""
        if self.candidate is None:
            return Decision("hold", None, (REASON_SAMPLES,))
        self.windows_observed += 1
        passed, breaches, holds = evaluate_gates(
            challenger, control, self.gates,
            candidate_age_s=self.candidate_age_s(now_s))
        version = self.candidate
        if breaches:
            for r in breaches:
                self.breaches_by_reason[r] = \
                    self.breaches_by_reason.get(r, 0) + 1
            return self._demote(version, breaches)
        if holds:
            self.holds += 1
            trace_lib.instant("promote.hold", version=version,
                              reasons=",".join(holds))
            return Decision("hold", version, tuple(holds))
        self.passing_windows += 1
        if self.passing_windows >= self.gates.windows_required:
            return self._promote(version)
        trace_lib.instant("promote.window_pass", version=version,
                          passing=self.passing_windows,
                          required=self.gates.windows_required)
        return Decision("pass", version)

    # ------------------------------------------------------- pointer moves
    def _wall(self) -> Optional[float]:
        return self._wall_time() if self._wall_time is not None else None

    def _promote(self, version: str) -> Decision:
        with trace_lib.span("promote.advance", version=version,
                            windows=self.passing_windows):
            export_lib.append_pointer_event(
                self._dir, version, "promote",
                f"passed {self.passing_windows} windows",
                wall_time=self._wall())
            faults_lib.check_publish_crash("after_history_before_latest")
            export_lib.write_latest(self._dir, version)
        self.stable_version = version
        self.candidate = None
        self._candidate_since = None
        self.passing_windows = 0
        self.promotions += 1
        return Decision("promote", version)

    def _demote(self, version: str, breaches: List[str]) -> Decision:
        reason = ",".join(breaches)
        if self._on_rollback is not None:
            try:
                self._on_rollback(version, reason)   # kill-switch first
            except Exception:  # noqa: BLE001 — a bad hook must not stop it
                pass
        with trace_lib.span("promote.rollback", version=version,
                            reason=reason):
            export_lib.append_pointer_event(
                self._dir, self.stable_version, "rollback",
                f"{version}: {reason}", wall_time=self._wall())
            faults_lib.check_publish_crash("after_history_before_latest")
            export_lib.write_latest(self._dir, self.stable_version)
        self.rollbacks += 1
        self.candidate = None
        self._candidate_since = None
        self.passing_windows = 0
        self.failures[version] = self.failures.get(version, 0) + 1
        if self.failures[version] >= QUARANTINE_FAILURES:
            self.quarantined.add(version)
            self.quarantines += 1
            export_lib.append_pointer_event(
                self._dir, version, "quarantine",
                f"failed {self.failures[version]}x: {reason}",
                wall_time=self._wall())
            trace_lib.instant("promote.quarantine", version=version,
                              reason=reason)
            return Decision("quarantine", version, tuple(breaches))
        return Decision("rollback", version, tuple(breaches))

    # ------------------------------------------------------------- surface
    def history(self) -> List[Dict[str, Any]]:
        return export_lib.pointer_history(self._dir)

    def stats(self) -> Dict[str, Any]:
        return {
            "stable_version": self.stable_version,
            "candidate_version": self.candidate,
            "passing_windows": self.passing_windows,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "quarantines": self.quarantines,
            "quarantined_versions": sorted(self.quarantined),
            "offers_refused": self.offers_refused,
            "windows_observed": self.windows_observed,
            "gate_holds": self.holds,
            "gate_breaches_by_reason": dict(self.breaches_by_reason),
        }
