"""Step-time and throughput meter (the ``ThroughputMeter`` of
``deepfm_tpu.utils.profiling``)."""

from __future__ import annotations

import time
from typing import Dict, List


class ThroughputMeter:
    """Step-time and examples/sec accumulator on the host's clock.

    Per-step wall time includes the host's input handoff: the card runs
    behind the host by the launch queue, so in steady state the wall time
    per dispatch is the pipeline-limited step time. The first
    ``warmup_steps`` dispatches (kernel builds, allocator growth) are left
    out, and :meth:`record_drain` folds the final wait for the card into
    the rate."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._step_times: List[float] = []
        self._total_time = 0.0
        self._examples = 0
        self._n_updates = 0
        self._n_steps = 0
        self._drain = 0.0
        self._last = time.perf_counter()

    def update(self, n_examples: int, steps_done: int = 1) -> None:
        """Record one dispatch covering ``steps_done`` optimizer steps."""
        now = time.perf_counter()
        self._n_updates += 1
        self._n_steps += steps_done
        if self._n_updates > self.warmup_steps:
            interval = now - self._last
            self._total_time += interval
            self._step_times.append(interval / max(steps_done, 1))
            self._examples += n_examples
        self._last = now

    def record_drain(self) -> None:
        """Fold the wait for the last dispatch into the rate (call after
        synchronizing with the card)."""
        now = time.perf_counter()
        self._drain += now - self._last
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._step_times:
            return {"steps": float(self._n_steps)}
        ts = sorted(self._step_times)
        n = len(ts)
        return {
            "steps": float(self._n_steps),
            "examples_per_sec": self._examples / max(
                self._total_time + self._drain, 1e-9),
            "step_ms_mean": 1000.0 * sum(ts) / n,
            "step_ms_p50": 1000.0 * ts[n // 2],
            "step_ms_p99": 1000.0 * ts[max(0, -(-99 * n // 100) - 1)],
        }
