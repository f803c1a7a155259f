"""Traffic-split experimentation: A/B, shadow, and canary arms over engines
(the port's copy of ``deepfm_tpu.serve.experiment``).

Production serving is never one model: every candidate earns live traffic
through a gated pipeline (shadow-validate, canary, promote — see
``train/promote.py`` for the controller that moves ``LATEST``). This module
is the request-path half: a router in front of two engines (control +
challenger — each a :class:`~deepfm_tpu_torch.serve.engine.ServingEngine`,
:class:`~deepfm_tpu_torch.serve.replicas.ReplicatedEngine`, or anything with
the same ``submit()`` surface) that assigns every request an **arm** and keeps
the challenger from ever hurting the primary lane.

Arm assignment is a pure function of ``(seed, request_id)`` — a seeded
integer hash threshold, no RNG state, no time — so a replayed request lands
on the identical arm and a drill's split is bit-reproducible (the same
property every audit fingerprint in this repo is built on). Granularity is
permille (0–1000) so a 0.5% canary is expressible.

The three modes:

  * **ab** — live split: a request's arm serves its response. Both arms are
    production; the split percentage is the experiment design.
  * **canary** — same mechanics as ``ab`` (a small live slice), plus the
    operational contract: :meth:`ExperimentRouter.kill` is the instant
    kill-switch that collapses ALL traffic back to control (one flag flip,
    no pointer move, counted and span-traced). The promotion controller
    pulls it on a guardrail breach.
  * **shadow** — every request is served by control; assigned-challenger
    requests are ALSO duplicated to the challenger on a side lane whose
    response is observed (logged, measured, NaN-checked) but never
    returned. Isolation is enforced structurally: the primary future is
    returned before the shadow submit happens, the shadow submit and its
    completion callback are wrapped wall-to-wall, and nothing on the shadow
    path can touch the primary future. A challenger that raises, sheds,
    returns NaN, or sleeps past its SLO surfaces ONLY as a typed counter
    (``shadow_submit_rejected`` / ``shadow_errors`` / ``shadow_nonfinite``
    / ``shadow_slo_misses``) — tested in ``tests/test_torch_experiment.py``.

No torch import — the router is pure numpy + threading, same contract as the
rest of the light serving plane (``stats.py`` / ``admission.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs import metrics as metrics_lib
from ..obs import trace as trace_lib
from .admission import VALUE_DEFAULT

#: Arm ids as they ride the impression record (``loop.impressions.ARM_KEY``,
#: an optional int64 next to ``model_version``). Ints, not names, on the
#: wire; names only in summaries.
ARM_CONTROL = 0
ARM_CHALLENGER = 1
ARM_NAMES = {ARM_CONTROL: "control", ARM_CHALLENGER: "challenger"}

#: Router modes. "off" routes everything to control and duplicates nothing.
MODES = ("off", "shadow", "canary", "ab")

_MASK64 = (1 << 64) - 1


def _mix64(seed: int, request_id: int) -> int:
    """splitmix64-style avalanche of (seed, request_id) — stdlib-only and
    spec-pinned arithmetic, so the value (hence every arm decision built on
    it) is stable across platforms and numpy versions."""
    h = ((int(request_id) & _MASK64) * 0x9E3779B97F4A7C15
         + (int(seed) & _MASK64) * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _MASK64
    h ^= h >> 31
    return h


def assign_arm(request_id: int, *, seed: int,
               challenger_permille: int) -> int:
    """Deterministic arm for one request: challenger iff the seeded hash of
    the request id lands under the permille threshold. Pure — replaying the
    same (seed, id, permille) reproduces the identical split bit-for-bit,
    and nearby ids decorrelate (a client's sequential ids don't stripe)."""
    permille = int(challenger_permille)
    if permille <= 0:
        return ARM_CONTROL
    if permille >= 1000:
        return ARM_CHALLENGER
    return (ARM_CHALLENGER
            if _mix64(seed, request_id) % 1000 < permille else ARM_CONTROL)


class ExperimentRouter:
    """Two-arm traffic splitter with shadow isolation and a kill-switch.

    ``control`` / ``challenger`` are engines (anything with the
    ``submit(feat_ids, feat_vals, trace_id=..., value=...)`` surface
    returning a future with ``result()`` / ``add_done_callback()``). The
    router does NOT own them — the caller closes its engines; ``close()``
    here only detaches the challenger so late shadow callbacks can't race a
    teardown.

    ``on_shadow_result(request_id, probs, latency_ms)`` is the logging hook
    for shadow responses (the drill writes them to the impression log under
    the challenger arm); it runs on the engine's executor callback thread
    and is itself guarded — a raising hook is a counted shadow error, never
    a primary-lane perturbation.
    """

    def __init__(self, control: Any, challenger: Optional[Any] = None, *,
                 mode: str = "off", seed: int = 0,
                 challenger_permille: int = 50,
                 shadow_slo_ms: float = 0.0,
                 on_shadow_result: Optional[
                     Callable[[int, np.ndarray, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if not 0 <= int(challenger_permille) <= 1000:
            raise ValueError(
                f"challenger_permille must be in [0, 1000], got "
                f"{challenger_permille}")
        if mode != "off" and challenger is None:
            raise ValueError(f"mode {mode!r} needs a challenger engine")
        self.control = control
        self.challenger = challenger
        self.mode = mode
        self.seed = int(seed)
        self.challenger_permille = int(challenger_permille)
        self.shadow_slo_ms = float(shadow_slo_ms)
        self._on_shadow_result = on_shadow_result
        self._clock = clock
        self._lock = threading.Lock()
        self._killed = False
        self.kill_reason: Optional[str] = None
        # Typed counters: the ONLY way shadow-lane trouble surfaces.
        self.requests_by_arm: Dict[int, int] = {ARM_CONTROL: 0,
                                                ARM_CHALLENGER: 0}
        self.shadow_submitted = 0
        self.shadow_completed = 0
        self.shadow_submit_rejected = 0   # challenger.submit itself refused
        self.shadow_errors = 0            # shadow future resolved with error
        self.shadow_nonfinite = 0         # shadow probs contained NaN/Inf
        self.shadow_slo_misses = 0        # shadow latency > shadow_slo_ms
        self.kills = 0
        self.shadow_latencies_ms: List[float] = []
        metrics_lib.auto_register("experiment", self)

    # ---------------------------------------------------------- assignment
    @property
    def killed(self) -> bool:
        return self._killed

    def assign(self, request_id: int) -> int:
        """The experiment-design arm for ``request_id`` (pure; ignores the
        kill-switch — :meth:`serving_arm` is what routing actually uses)."""
        return assign_arm(request_id, seed=self.seed,
                          challenger_permille=self.challenger_permille)

    def serving_arm(self, request_id: int) -> int:
        """The arm whose engine SERVES this request's response: always
        control when off / killed / shadowing; the assigned arm only for
        live-split modes (ab, canary)."""
        if (self.mode in ("ab", "canary") and not self._killed
                and self.challenger is not None):
            return self.assign(request_id)
        return ARM_CONTROL

    # ------------------------------------------------------------- routing
    def submit(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
               request_id: int, *, trace_id: Optional[int] = None,
               value: str = VALUE_DEFAULT,
               affinity: Optional[int] = None) -> Any:
        """Route one request. Returns the PRIMARY future (stamped with
        ``.arm``); any shadow duplication happens after the primary future
        already exists and cannot reach it. Primary-lane errors (overload,
        shed, validation) propagate exactly as the underlying engine raises
        them — the router adds no failure modes to the primary path."""
        arm = self.serving_arm(request_id)
        engine = self.challenger if arm == ARM_CHALLENGER else self.control
        fut = self._submit(engine, feat_ids, feat_vals, trace_id=trace_id,
                           value=value, affinity=affinity)
        try:
            fut.arm = arm
        except AttributeError:     # __slots__ futures without an arm slot
            pass
        with self._lock:
            self.requests_by_arm[arm] = self.requests_by_arm.get(arm, 0) + 1
        if (self.mode == "shadow" and not self._killed
                and self.challenger is not None
                and self.assign(request_id) == ARM_CHALLENGER):
            self._shadow(feat_ids, feat_vals, request_id, trace_id=trace_id,
                         value=value)
        return fut

    def predict(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
                request_id: int, timeout: Optional[float] = None,
                **kw: Any) -> np.ndarray:
        return self.submit(feat_ids, feat_vals, request_id, **kw).result(
            timeout)

    @staticmethod
    def _submit(engine: Any, feat_ids: np.ndarray, feat_vals: np.ndarray,
                *, trace_id: Optional[int], value: str,
                affinity: Optional[int], bypass_cache: bool = False) -> Any:
        kw: Dict[str, Any] = {"trace_id": trace_id, "value": value}
        if affinity is not None and getattr(engine, "supports_affinity",
                                            False):
            kw["affinity"] = affinity
        if bypass_cache and getattr(engine, "supports_cache_bypass", False):
            kw["bypass_cache"] = True
        return engine.submit(feat_ids, feat_vals, **kw)

    # -------------------------------------------------------- shadow lane
    def _shadow(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
                request_id: int, *, trace_id: Optional[int],
                value: str) -> None:
        """Fire-and-observe duplicate to the challenger. Guarded
        wall-to-wall: ANY exception (typed refusal, validation, a dead
        engine) becomes ``shadow_submit_rejected`` — never the caller's
        problem. Shadow submits BYPASS the challenger's result cache (when
        it advertises ``supports_cache_bypass``): the lane exists to
        measure the challenger's real predict path, and its duplicated
        traffic must neither read nor warm entries the live lane sees."""
        t0 = self._clock()
        try:
            sfut = self._submit(self.challenger, feat_ids, feat_vals,
                                trace_id=trace_id, value=value,
                                affinity=None, bypass_cache=True)
        except Exception:  # noqa: BLE001 — isolation IS the contract
            with self._lock:
                self.shadow_submit_rejected += 1
            return
        with self._lock:
            self.shadow_submitted += 1
        sfut.add_done_callback(
            lambda f: self._shadow_done(f, request_id, t0))

    def _shadow_done(self, fut: Any, request_id: int, t0: float) -> None:
        """Observe one shadow resolution on the challenger's executor
        thread. Fully guarded — a raising user hook or a malformed future
        counts as a shadow error and nothing else."""
        try:
            latency_ms = 1000.0 * (self._clock() - t0)
            if getattr(fut, "_error", None) is not None:
                with self._lock:
                    self.shadow_errors += 1
                return
            probs = fut._probs
            finite = bool(np.all(np.isfinite(probs)))
            with self._lock:
                self.shadow_completed += 1
                self.shadow_latencies_ms.append(latency_ms)
                if not finite:
                    self.shadow_nonfinite += 1
                if self.shadow_slo_ms > 0 and latency_ms > self.shadow_slo_ms:
                    self.shadow_slo_misses += 1
            if self._on_shadow_result is not None:
                self._on_shadow_result(request_id, probs, latency_ms)
        except Exception:  # noqa: BLE001 — shadow trouble never escapes
            with self._lock:
                self.shadow_errors += 1

    # --------------------------------------------------------- kill-switch
    def kill(self, reason: str = "") -> None:
        """Instant kill-switch: all subsequent traffic serves from control
        and shadow duplication stops. One flag under the lock — no pointer
        move, no engine teardown, effective on the very next request."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
            self.kill_reason = str(reason)
            self.kills += 1
        trace_lib.instant("experiment.kill", mode=self.mode,
                          reason=str(reason))

    def revive(self) -> None:
        """Re-open the experiment after a kill (a NEW candidate earned a
        fresh shot); counters keep accumulating — they are the audit."""
        with self._lock:
            self._killed = False
            self.kill_reason = None

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            lat = list(self.shadow_latencies_ms)
            out = {
                "experiment_mode": self.mode,
                "experiment_killed": self._killed,
                "experiment_kills": self.kills,
                "experiment_kill_reason": self.kill_reason,
                "experiment_permille": self.challenger_permille,
                "arm_control_requests": self.requests_by_arm.get(
                    ARM_CONTROL, 0),
                "arm_challenger_requests": self.requests_by_arm.get(
                    ARM_CHALLENGER, 0),
                "shadow_submitted": self.shadow_submitted,
                "shadow_completed": self.shadow_completed,
                "shadow_submit_rejected": self.shadow_submit_rejected,
                "shadow_errors": self.shadow_errors,
                "shadow_nonfinite": self.shadow_nonfinite,
                "shadow_slo_misses": self.shadow_slo_misses,
            }
        out["shadow_p50_ms"] = (
            float(np.percentile(np.asarray(lat, np.float64), 50))
            if lat else None)
        out["shadow_p99_ms"] = (
            float(np.percentile(np.asarray(lat, np.float64), 99))
            if lat else None)
        return out

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Detach the challenger (late shadow callbacks still resolve into
        counters harmlessly). Engines belong to the caller."""
        with self._lock:
            self._killed = True
        self.challenger = None
