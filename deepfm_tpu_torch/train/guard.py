"""Training-runtime numerical guard and health accounting (the ``abort``
policy of ``deepfm_tpu.train.guard``).

:class:`NonFiniteGuard` classifies the loss the fit loop already reads at
its log cadence (plus one on-device all-finite check of the params) and
raises :class:`NonFiniteError` naming the step on a non-finite value: the
default ``--on_nonfinite abort``. It adds no device read of its own per
dispatch. Its advisory EMA z-score loss-spike detector is ported as is.
The ``skip`` and ``rollback`` policies and the stall watchdog are not
ported yet and raise.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, Optional

import torch

from ..obs import metrics as metrics_lib

log = logging.getLogger(__name__)


class TrainHealth:
    """Thread-safe counters for runtime faults the train loop survived (the
    ones the ported policies can record)."""

    COUNTERS = ("loss_spikes", "resume_meta_corrupt")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.loss_spikes = 0          # EMA z-score outliers (warned only)
        self.resume_meta_corrupt = 0  # unreadable resume sidecars tolerated
        metrics_lib.auto_register("train_health", self)

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def record_loss_spike(self) -> None:
        self._bump("loss_spikes")

    def record_resume_meta_corrupt(self) -> None:
        self._bump("resume_meta_corrupt")

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {k: int(getattr(self, k)) for k in self.COUNTERS}


class NonFiniteError(RuntimeError):
    """A non-finite loss or parameter under ``on_nonfinite=abort``. The
    message carries the step number."""


POLICIES = ("abort", "skip", "rollback")


class NonFiniteGuard:
    """Non-finite detection at the log cadence + EMA z-score spike
    detector (advisory: it warns and counts, never stops a run)."""

    def __init__(self, policy: str = "abort",
                 health: Optional[TrainHealth] = None,
                 spike_zscore: float = 0.0, spike_warmup: int = 20,
                 ema_alpha: float = 0.1):
        if policy not in POLICIES:
            raise ValueError(
                f"on_nonfinite must be one of {POLICIES}, got {policy!r}")
        if policy != "abort":
            raise NotImplementedError(
                f"--on_nonfinite {policy} is not yet ported to "
                "deepfm_tpu_torch (only abort is)")
        self.policy = policy
        self.health = health if health is not None else TrainHealth()
        self.spike_zscore = float(spike_zscore)
        self.spike_warmup = int(spike_warmup)
        self._alpha = float(ema_alpha)
        self._ema = 0.0
        self._var = 0.0
        self._n_obs = 0

    @classmethod
    def from_config(cls, cfg: Any, health: Optional[TrainHealth] = None
                    ) -> "NonFiniteGuard":
        return cls(policy=cfg.on_nonfinite, health=health,
                   spike_zscore=cfg.loss_spike_zscore)

    @staticmethod
    def params_nonfinite(params: Dict[str, torch.Tensor]) -> bool:
        """True when any floating param holds a non-finite value (one
        device reduction and one read)."""
        flags = [torch.isfinite(p).all() for p in params.values()
                 if p.is_floating_point()]
        return bool(flags) and not bool(torch.stack(flags).all())

    def _observe_spike(self, loss: float, step: int) -> None:
        if self.spike_zscore <= 0.0:
            return
        self._n_obs += 1
        if self._n_obs == 1:
            self._ema = loss
            self._var = 0.0
            return
        dev = loss - self._ema
        if self._n_obs > self.spike_warmup:
            z = abs(dev) / math.sqrt(max(self._var, 1e-12))
            if z > self.spike_zscore:
                self.health.record_loss_spike()
                log.warning(
                    "loss spike at step %d: loss=%.5f is %.1f sigma from EMA "
                    "%.5f (threshold %s); continuing", step, loss, z,
                    self._ema, self.spike_zscore)
                return  # a spike must not poison its own baseline
        self._ema += self._alpha * dev
        self._var = (1 - self._alpha) * (self._var + self._alpha * dev * dev)

    def observe(self, loss: float, step: int, *,
                params_bad: bool = False) -> str:
        """Classify one logged dispatch: ``"ok"``, or raise
        :class:`NonFiniteError`. ``step`` is the global step after it."""
        if math.isfinite(loss) and not params_bad:
            self._observe_spike(loss, step)
            return "ok"
        what = (f"non-finite loss ({loss})" if not math.isfinite(loss)
                else "non-finite parameters")
        raise NonFiniteError(f"{what} at step {step} (on_nonfinite=abort)")
