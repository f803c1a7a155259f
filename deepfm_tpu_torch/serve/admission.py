"""SLO-aware admission control: shed lowest-value work first, with hysteresis.

The engine's only pressure answer used to be queue-full
:class:`~deepfm_tpu_torch.serve.engine.ServerOverloaded` — a hard wall that hits
every caller equally, and only once the queue is ALREADY the full SLO-budget
deep. This module puts a value-aware gate in FRONT of that wall:

  * **value classes** — every request carries one of :data:`VALUE_CLASSES`
    (lowest value first). The priority small lane generalizes into this:
    lanes say *how* a request batches, classes say *whether* it is admitted
    under pressure.
  * **pressure** — the max of two normalized signals: queue depth over the
    shed watermark (``pending_rows / shed_watermark``), and the EWMA of the
    measured queue delay over the SLO-derived delay budget
    (``delay_ms / (slo_ms * slo_fraction)``). Either signal crossing 1.0
    means the engine is no longer meeting its SLO for work already queued —
    adding more low-value work only makes every response later.
  * **hysteresis ladder** — the shed level rises when pressure crosses an
    enter threshold (level L engages at ``1 + (L-1) * step``) and falls only
    when pressure drops below ``hysteresis *`` that threshold, so an
    oscillation around a watermark cannot flap the gate open/closed on every
    request. Level L sheds the L lowest value classes with a typed
    :class:`AdmissionShed` — distinct from ``ServerOverloaded`` so callers
    can tell "the server chose to refuse my class" from "the queue is
    physically full". The HIGHEST class is never admission-shed: it only
    ever hits the queue-full wall.

Exact-watermark tie rule: enter thresholds compare with ``>=``, so pressure
landing EXACTLY on the watermark already sheds the lowest class — at the
boundary the gate protects the SLO rather than the marginal request.

The same :class:`HysteresisLadder` drives the cascade's degraded-mode rungs
(:class:`DegradationLadder`): shrink ``retrieve_k`` first, then skip the
ranker — every transition counted and trace-stamped, never silent.

This module imports neither torch nor numpy (stats/trace only).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import trace as trace_lib

#: Value classes, LOWEST value first. "bulk" is offline/backfill-grade
#: traffic (shed first), "normal" is the default interactive class,
#: "critical" is never admission-shed (queue-full still applies).
VALUE_CLASSES: Tuple[str, ...] = ("bulk", "normal", "critical")
VALUE_DEFAULT = "normal"


class AdmissionShed(RuntimeError):
    """The admission gate refused this request's VALUE CLASS under pressure.

    Distinct from :class:`~deepfm_tpu_torch.serve.engine.ServerOverloaded` (queue
    physically full): a shed is a policy decision — higher-value classes are
    still being admitted, and the caller should degrade or drop rather than
    retry immediately.
    """


class HysteresisLadder:
    """A monotone level ladder over a scalar pressure signal, with
    hysteresis: level L engages when pressure >= ``enter_at + (L-1)*step``
    (``>=`` — the exact-watermark tie escalates) and releases only when
    pressure < ``hysteresis`` x that same threshold. Between the release
    and enter thresholds the level HOLDS — oscillating load cannot flap it.

    Not thread-safe by itself; callers serialize ``update`` (the admission
    controller and the cascade both update under their own locks).
    """

    def __init__(self, levels: int, *, enter_at: float = 1.0,
                 step: float = 0.5, hysteresis: float = 0.7,
                 on_transition: Optional[
                     Callable[[int, int, float], None]] = None):
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        if not 0.0 < hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in (0, 1), got {hysteresis}")
        if step <= 0 or enter_at <= 0:
            raise ValueError(
                f"need positive enter_at/step, got {enter_at}/{step}")
        self.levels = int(levels)
        self._enter = [enter_at + (lv - 1) * step
                       for lv in range(1, self.levels)]
        self._hysteresis = float(hysteresis)
        self._on_transition = on_transition
        self.level = 0
        self.transitions = 0
        # Bounded recent-transition log: (from, to, pressure) — the drill
        # asserts the ladder engaged AND recovered from this.
        self.transition_log: List[Tuple[int, int, float]] = []

    def enter_threshold(self, level: int) -> float:
        """Pressure at which ``level`` engages (level >= 1)."""
        return self._enter[level - 1]

    def update(self, pressure: float) -> int:
        """Advance the ladder for one observation; returns the new level."""
        p = float(pressure)
        up = 0
        for lv in range(1, self.levels):
            if p >= self._enter[lv - 1]:
                up = lv
        if up > self.level:
            target = up
        else:
            down = 0
            for lv in range(1, self.levels):
                if p >= self._hysteresis * self._enter[lv - 1]:
                    down = lv
            target = min(self.level, max(down, up))
        if target != self.level:
            prev, self.level = self.level, target
            self.transitions += 1
            if len(self.transition_log) < 256:
                self.transition_log.append((prev, target, p))
            if self._on_transition is not None:
                self._on_transition(prev, target, p)
        return self.level


class AdmissionController:
    """The SLO-aware gate one engine consults before its queue-full check.

    ``admit(value, pending_rows)`` raises :class:`AdmissionShed` when the
    request's value class falls below the current shed level; otherwise it
    returns the level (0 = everything admitted). All counters land in the
    engine's :class:`~deepfm_tpu_torch.serve.stats.ServingStats` so the summary
    reconciles: offered == completed + failed + overloads + sheds.

    Each engine owns ITS controller (pressure is per-queue); replicas never
    share one.
    """

    def __init__(self, *, slo_ms: float = 0.0, shed_watermark: int = 0,
                 queue_rows: int = 0,
                 classes: Sequence[str] = VALUE_CLASSES,
                 hysteresis: float = 0.7, step: float = 0.5,
                 slo_fraction: float = 0.5, delay_alpha: float = 0.2,
                 stats: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        if slo_ms < 0:
            raise ValueError(f"slo_ms must be >= 0, got {slo_ms}")
        if shed_watermark < 0:
            raise ValueError(
                f"shed_watermark must be >= 0, got {shed_watermark}")
        if len(classes) < 2:
            raise ValueError(
                f"need >= 2 value classes to shed by value, got {classes!r}")
        self.slo_ms = float(slo_ms)
        # Watermark default: half the queue — shedding starts while the
        # queue can still absorb a burst of higher-value work.
        self.shed_watermark = int(shed_watermark) or max(1, queue_rows // 2)
        self.classes = tuple(classes)
        self._rank = {c: i for i, c in enumerate(self.classes)}
        self.slo_fraction = float(slo_fraction)
        self._alpha = float(delay_alpha)
        self.stats = stats
        self._clock = clock
        self._lock = threading.Lock()
        self._ewma_delay_ms: Optional[float] = None
        self._ewma_at: Optional[float] = None
        # Max level sheds all but the highest class.
        self._ladder = HysteresisLadder(
            len(self.classes), hysteresis=hysteresis, step=step,
            on_transition=self._on_transition)

    # ------------------------------------------------------------ signals
    def _on_transition(self, prev: int, new: int, pressure: float) -> None:
        trace_lib.instant("serve.admission_level", prev=prev, level=new,
                          pressure=round(pressure, 4))
        if self.stats is not None:
            self.stats.record_admission_transition(new)

    def rank(self, value: str) -> int:
        try:
            return self._rank[value]
        except KeyError:
            raise ValueError(
                f"unknown value class {value!r}; expected one of "
                f"{self.classes}") from None

    def observe_delay(self, delay_ms: float) -> None:
        """Feed one measured queue delay (enqueue → batch formation)."""
        with self._lock:
            if self._ewma_delay_ms is None:
                self._ewma_delay_ms = float(delay_ms)
            else:
                self._ewma_delay_ms += self._alpha * (
                    float(delay_ms) - self._ewma_delay_ms)
            self._ewma_at = self._clock()

    def pressure(self, pending_rows: int) -> float:
        """Max of the depth and delay signals, each normalized to 1.0 at
        its watermark.

        The delay EWMA is a TRAILING indicator: once the gate (or the
        cascade's retrieval-only rung) stops work from reaching the
        batcher, no new delays are observed and a peak reading would pin
        the pressure high forever. So the delay signal ages: it halves
        per ``slo_ms`` elapsed since the last observation — under live
        traffic the age is ~0 and nothing changes, while a drained queue
        releases the ladder within a few SLOs instead of wedging
        degraded."""
        depth = pending_rows / self.shed_watermark
        with self._lock:
            ewma, at = self._ewma_delay_ms, self._ewma_at
        if self.slo_ms > 0 and ewma is not None:
            half_life_s = self.slo_ms / 1000.0
            age_s = max(0.0, self._clock() - at)
            stale = ewma * (0.5 ** (age_s / half_life_s))
            return max(depth, stale / (self.slo_ms * self.slo_fraction))
        return depth

    # ------------------------------------------------------------- gating
    @property
    def level(self) -> int:
        with self._lock:
            return self._ladder.level

    @property
    def transitions(self) -> int:
        with self._lock:
            return self._ladder.transitions

    def admit(self, value: str, pending_rows: int) -> int:
        """Raise :class:`AdmissionShed` if ``value`` is below the current
        shed level; returns the level otherwise."""
        rank = self.rank(value)
        p = self.pressure(pending_rows)
        with self._lock:
            level = self._ladder.update(p)
        if rank < level:
            if self.stats is not None:
                self.stats.record_shed(value)
            raise AdmissionShed(
                f"admission shed: class {value!r} (rank {rank}) below shed "
                f"level {level} at pressure {p:.2f} "
                f"({pending_rows} rows pending, watermark "
                f"{self.shed_watermark}); degrade or retry later")
        return level

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "admission_level": self._ladder.level,
                "admission_transitions": self._ladder.transitions,
                "admission_watermark_rows": self.shed_watermark,
                "admission_slo_ms": self.slo_ms or None,
                "admission_ewma_delay_ms": (
                    round(self._ewma_delay_ms, 3)
                    if self._ewma_delay_ms is not None else None),
            }


#: Degradation rungs, healthy first: full cascade → shrunken retrieve_k →
#: ranker skipped (retrieval-order results).
DEGRADE_RUNGS: Tuple[str, ...] = ("full", "reduced_retrieve",
                                  "retrieval_only")


class DegradationLadder:
    """The cascade's graceful-degradation state machine over the same
    hysteresis ladder: rung 1 shrinks ``retrieve_k``, rung 2 answers from
    retrieval order without ranking. Every transition is an explicit,
    counted, trace-stamped event (``serve.degrade``) — a degraded answer is
    a product decision, never a silent quality drop."""

    def __init__(self, *, hysteresis: float = 0.7, step: float = 0.5,
                 stats: Any = None):
        self.stats = stats
        self._lock = threading.Lock()
        self._ladder = HysteresisLadder(
            len(DEGRADE_RUNGS), hysteresis=hysteresis, step=step,
            on_transition=self._on_transition)

    def _on_transition(self, prev: int, new: int, pressure: float) -> None:
        trace_lib.instant(
            "serve.degrade", prev=DEGRADE_RUNGS[prev],
            rung=DEGRADE_RUNGS[new], pressure=round(pressure, 4))
        if self.stats is not None:
            self.stats.record_degrade_transition(DEGRADE_RUNGS[new])

    @property
    def rung(self) -> int:
        with self._lock:
            return self._ladder.level

    @property
    def rung_name(self) -> str:
        return DEGRADE_RUNGS[self.rung]

    @property
    def transitions(self) -> int:
        with self._lock:
            return self._ladder.transitions

    @property
    def transition_log(self) -> List[Tuple[int, int, float]]:
        with self._lock:
            return list(self._ladder.transition_log)

    def update(self, pressure: float) -> int:
        with self._lock:
            return self._ladder.update(pressure)
