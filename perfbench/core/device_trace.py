"""The traced window: ``torch.profiler`` over the window's calls, reduced to
device operations, the program's spans, busy time and idle gaps.

The profiler records the device alone (CUDA activity: kernels, copies,
sets and the launches), not the host's operators, whose recording would
slow the host side of the window by tens of percent. Its Chrome trace is
written to a temporary directory (under ``TMPDIR``) and read back.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceOp:
    __slots__ = ("name", "cat", "start_ns", "dur_ns")

    def __init__(self, name, cat, start_ns, dur_ns):
        self.name, self.cat = name, cat
        self.start_ns, self.dur_ns = start_ns, dur_ns


def parse_chrome_trace(data: Dict) -> List[DeviceOp]:
    """Device operations of a ``torch.profiler`` Chrome trace, in wall
    nanoseconds (the trace's ``baseTimeNanoseconds`` plus its
    microsecond stamps), by start."""
    base = int(data.get("baseTimeNanoseconds", 0))
    out = [DeviceOp(ev.get("name", ""), ev["cat"],
                    base + int(float(ev["ts"]) * 1e3),
                    int(float(ev.get("dur", 0)) * 1e3))
           for ev in data.get("traceEvents", [])
           if ev.get("cat") in DEVICE_CATS and ev.get("ph") == "X"]
    out.sort(key=lambda d: d.start_ns)
    return out


def profile(fn: Callable[[], object], sync: Callable[[], None]
            ) -> Tuple[object, List[DeviceOp], int, int]:
    """Run ``fn`` under the profiler. Returns its result, the device
    operations inside the window, and the window's wall start and end in
    nanoseconds (``sync`` waits for the device before the end is read)."""
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity  # noqa: PLC0415
    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.time_ns()
        result = fn()
        sync()
        t1 = time.time_ns()
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    ops = [o for o in parse_chrome_trace(data)
           if o.start_ns + o.dur_ns > t0 and o.start_ns < t1]
    return result, ops, t0, t1


def busy_ns(ops: List[DeviceOp], t0: int, t1: int) -> int:
    """Length of the union of the operations' intervals inside [t0, t1]."""
    total, end = 0, t0
    for o in ops:
        a, b = max(o.start_ns, end), min(o.start_ns + o.dur_ns, t1)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(ops: List[DeviceOp], t0: int, t1: int) -> List[Tuple[int, int]]:
    """Idle intervals of the device inside [t0, t1]."""
    out, end = [], t0
    for o in ops:
        if o.start_ns > end:
            out.append((end, min(o.start_ns, t1)))
        end = max(end, o.start_ns + o.dur_ns)
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


def span_at(spans: List[Dict], t_ns: int) -> str:
    """The innermost program span around ``t_ns``, or ``no_span``."""
    best, best_dur = "no_span", None
    for s in spans:
        a = int(s["ts"] * 1e3)
        b = a + int(s.get("dur", 0) * 1e3)
        if a <= t_ns <= b and (best_dur is None or b - a < best_dur):
            best, best_dur = s["name"], b - a
    return best


def breakdown(ops: List[DeviceOp], spans: List[Dict], t0: int, t1: int
              ) -> Dict[str, List]:
    """The ten device operations that took most time and the ten longest
    idle totals by the host span they fell in, in seconds."""
    by_name: Dict[str, int] = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0) + o.dur_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle: Dict[str, int] = {}
    for a, b in gaps(ops, t0, t1):
        label = span_at(spans, (a + b) // 2)
        idle[label] = idle.get(label, 0) + (b - a)
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:64], v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in gap_top]}


class Context:
    """What a per-layer metric's reader reads: one card's traced window."""

    def __init__(self, *, ops: List[DeviceOp], spans: List[Dict], t0: int,
                 t1: int, steps: int, examples_per_s: float, cards: int,
                 shapes: Dict, peaks: Dict, kernel: Callable):
        self.ops, self.spans = ops, spans
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) / 1e9
        self.steps = steps
        self.examples_per_s = examples_per_s
        self.cards = cards
        self.shapes = shapes
        self.peaks = peaks
        self.kernel = kernel

    def kernels(self, match) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel"
                and any(m in o.name for m in match)]

    def seconds(self, ops: List[DeviceOp]) -> float:
        return sum(o.dur_ns for o in ops) / 1e9

    def least_seconds(self, kernel: str) -> float:
        """The least time one step of ``kernel`` could take: per product
        or launch, the larger of its operations over the peak of its
        dtype and its bytes over the memory's, summed."""
        mod = self.kernel(kernel)
        p = self.peaks
        return sum(max(fl / p[peak], nb / p["hbm_bytes_per_s"])
                   for fl, nb, peak in mod.need(self.shapes))

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """The kernel's share of its roofline over the window, or None
        where the window ran none of it."""
        mod = self.kernel(kernel)
        t = self.seconds(self.kernels(mod.MATCH))
        least = self.least_seconds(kernel) * self.steps
        if t <= 0 or least <= 0:
            return None
        return 100.0 * least / t

    def busy_s(self) -> float:
        return busy_ns(self.ops, self.t0, self.t1) / 1e9

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)


def finite_or_none(x: Optional[float]) -> Optional[float]:
    if x is None or not np.isfinite(x):
        return None
    return float(x)
