"""Step-time and throughput meter, the host input path's per-stage timer
and the profiler's step window (the ``ThroughputMeter``,
``HostStageStats`` and ``StepWindowTracer`` of
``deepfm_tpu.utils.profiling``). Named regions of a run are
``obs.trace`` spans, timed on the card too where given a device."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

from ..obs import metrics as metrics_lib

log = logging.getLogger(__name__)


def _activities(cuda: bool):
    import torch  # noqa: PLC0415 (profiling is opt-in)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, profile_dir: str, cuda: bool) -> str:
    """Stop ``prof`` and write its Chrome trace as the next
    ``trace-<pid>-<n>.json`` of ``profile_dir``; returns the path."""
    if cuda:
        import torch  # noqa: PLC0415
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    n = len([f for f in os.listdir(profile_dir)
             if f.startswith(f"trace-{os.getpid()}-")])
    path = os.path.join(profile_dir, f"trace-{os.getpid()}-{n}.json")
    prof.export_chrome_trace(path)
    return path


class StepWindowTracer:
    """Trace a bounded window of train steps with ``torch.profiler``.

    Tracing every step of a long run buffers an unloadable trace; the
    signal is a few steady-state steps. The window opens once ``start_step``
    steps have run (past the first calls' kernel builds and allocator
    growth) and closes after ``num_steps`` more; the trace is exported as
    Chrome-trace JSON (``trace-<pid>-<n>.json``) into ``profile_dir``. On
    the card it records CUDA activity (every kernel launched in the
    process, the hand-written ones included) beside the CPU's; on the CPU,
    CPU activity. ``on_step`` is a fit-loop hook (hooks fire once per
    dispatch, which may cover several steps); ``close`` ends a window still
    open when the run ends. A no-op when ``profile_dir`` is empty.
    """

    def __init__(self, profile_dir: Optional[str], *, start_step: int = 2,
                 num_steps: int = 20, device="cpu"):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self._cuda = str(device).startswith("cuda")
        self._seen = 0
        self._prof = None
        self._done = False
        self.trace_path: Optional[str] = None

    def on_step(self, steps_done: int = 1) -> None:
        if not self.profile_dir or self._done:
            return
        self._seen += steps_done
        if self._prof is None and self._seen >= self.start_step:
            import torch  # noqa: PLC0415 (profiling is opt-in)
            self._prof = torch.profiler.profile(
                activities=_activities(self._cuda))
            self._prof.start()
        elif (self._prof is not None
              and self._seen >= self.start_step + self.num_steps):
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        self.trace_path = _export(prof, self.profile_dir, self._cuda)
        log.info("profiler trace of steps %d..%d -> %s", self.start_step,
                 self._seen, self.trace_path)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


class HostStageStats:
    """Per-stage wall-time accumulator for the host input path.

    The pipeline brackets each stage of its hot loop with ``stage(name)``
    (``read``: stream bytes in; ``frame``: split TFRecord frames;
    ``decode_assemble``: proto decode scattered into the transfer-layout
    pool; ``emit``: slice batches off the pool) when a collector is
    attached as ``CtrPipeline.stage_stats``; detached (the default) every
    site is a no-op. Every stage runs on the pipeline generator's thread
    (a decode fanned out to reader threads is measured as the generator's
    wait), so the stages add up to most of the observed ns/record and the
    rest is Python glue.
    """

    def __init__(self) -> None:
        self.ns: Dict[str, int] = {}
        self.records = 0  # the caller sets the denominator
        metrics_lib.auto_register("host_stage", self)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.ns[name] = self.ns.get(name, 0) + (
                time.perf_counter_ns() - t0)

    def ns_per_record(self, records: Optional[int] = None
                      ) -> Dict[str, float]:
        """Per-stage ns/record; pass ``records`` or preset ``.records``."""
        n = max(int(records if records is not None else self.records), 1)
        return {name: round(total / n, 1)
                for name, total in sorted(self.ns.items())}


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
