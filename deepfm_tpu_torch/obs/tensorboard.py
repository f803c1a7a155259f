"""Scalar summaries for TensorBoard (port of ``deepfm_tpu.obs.tensorboard``).

The training loss and rate every ``log_steps``, each eval's AUC and loss,
the run's ``health/*`` counters and the publisher's ``publish/*`` stats,
written through ``torch.utils.tensorboard.SummaryWriter``. Where the
``tensorboard`` package does not import, the writer warns once and does
nothing, as the JAX writer does without TensorFlow. One process writes (the
port runs one). Not imported by ``obs/__init__``: the stdlib-only
``obs.trace`` and ``obs.metrics`` stay importable from spawned input
workers without torch.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class TensorBoardWriter:
    """Scalar writer; a no-op without ``logdir`` or without tensorboard."""

    def __init__(self, logdir: str):
        self._writer = None
        if not logdir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415
        except ImportError as exc:
            log.warning("tensorboard_dir set but tensorboard unavailable "
                        "(%s); summaries disabled", exc)
            return
        self._writer = SummaryWriter(log_dir=logdir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def scalars(self, step: int, **values: float) -> None:
        if self._writer is None:
            return
        for name, v in values.items():
            self._writer.add_scalar(name, v, int(step))

    def scalar_dict(self, step: int, prefix: str, values: dict) -> None:
        """Write every numeric entry of a stats dict as ``<prefix><key>``
        (strings, maps and None are skipped, so the publisher's
        ``stats()`` feeds straight through)."""
        if self._writer is None:
            return
        for name, v in values.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self._writer.add_scalar(f"{prefix}{name}", v, int(step))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
