"""One process's run of a cell and the result line it reports.

``run_process`` sets up, measures (``trace`` 0: the end-to-end metrics
over the timed window; 1: the per-layer metrics over the traced window),
reads the peak memory, frees the program and compares its first steps
with the reference.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

import torch

from . import compare
from . import device_trace
from . import registry
from . import train_cell

GIB = float(2**30)


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i",
             str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=20, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def run_process(cell: Dict, *, seed: int, seconds: float, trace: int,
                device, t0: float) -> Tuple[Dict, List[str]]:
    """One run: the result line and the check lines."""
    run = train_cell.Run(cell, seed=seed, device=device, t0=t0)
    run.setup()
    metrics: Dict[str, Dict] = {}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
    units.update({m["name"]: m["unit"] for m in cell["per_layer"]})
    extra: Dict = {}
    if trace:
        w = run.traced_window()
        ctx = w["ctx"]
    else:
        w = run.window(seconds)
    attempted = w["steps"]
    peak = int(torch.cuda.max_memory_allocated(run.device)
               if run.device.type == "cuda" else 0)
    finite = bool(torch.isfinite(torch.tensor(run.last_loss)))
    if trace:
        for m in cell["per_layer"]:
            value = device_trace.finite_or_none(
                registry.metric(m["name"], cell["root"]).read(ctx))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        extra["busy_s"] = ctx.busy_s()
        extra["window_s"] = ctx.window_s
        bd = device_trace.breakdown(ctx.ops, ctx.spans, ctx.t0, ctx.t1)
    else:
        values = {"train_examples_per_s": w["examples_per_s"],
                  "peak_device_mem_gib": peak / GIB,
                  "setup_s": run.setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    card = card_line(run.device)
    kind = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu")
    run.free_program()
    # The reference, after the window and the peak, with the program freed.
    readings = run.reference()
    numbers = compare.gaps(run.checked, readings)
    limits = cell["limits"]
    correct = compare.judge(numbers, limits) and finite
    lines = [f"card: {card}", f"setup_s: {run.setup_s!r} (" + ", ".join(
        f"{name} {sec:.3f}" for name, sec in run.stages) + ")"]
    lines += compare.check_lines(numbers, limits)
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if finite else attempted, "metrics": metrics,
              "device": {"platform": "gpu" if run.device.type == "cuda"
                         else run.device.type, "kind": kind, "count": 1,
                         "memory_peak_bytes": peak, **extra}}
    if trace:
        result["breakdown"] = bd
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result, lines
