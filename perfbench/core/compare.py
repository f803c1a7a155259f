"""The comparison that decides ``correct`` for a training cell.

Three numbers, each against a limit of the cell's own
(``perfbench/limits/<workload>.json``):

* ``loss_gap``: the largest relative gap between the program's loss and
  the reference's over the first steps;
* ``grad_gap``: the first gradient as the optimizer got it, leaf by leaf:
  the gap between the program's norm and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf, worst leaf;
* ``change_gap``: the same for every leaf's change over the steps;
* ``grad_gap_geomean``: the first gradient's leaf gaps as ``grad_gap``
  takes them, their geometric mean over the leaves: steady from seed to
  seed where the worst leaf is a small bias whose bfloat16 sum swings.

A cell compares the numbers its limits name.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf numbers: Adam moves such a leaf by
round-off alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

#: A leaf whose reference gradient norm is below this share of the median
#: leaf's is not compared.
SILENT_LEAF = 1e-3


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """float64 norm of every leaf."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tree.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Sequence[str]) -> np.ndarray:
    med = float(np.median([ref[k] for k in leaves]))
    return np.array([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                     for k in leaves])


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses": [...], "grad1": {leaf: norm},
    "change": {leaf: norm}}``."""
    g_ref = ref["grad1"]
    med = float(np.median(list(g_ref.values())))
    leaves = [k for k, v in g_ref.items() if v >= SILENT_LEAF * med]
    losses: List[float] = list(prog["losses"])
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(losses, ref["losses"]))
    if len(losses) != len(ref["losses"]) or not all(
            np.isfinite(x) for x in losses):
        loss_gap = float("inf")
    grad = _leaf_gaps(prog["grad1"], g_ref, leaves)
    return {"loss_gap": loss_gap, "grad_gap": float(grad.max()),
            "change_gap": float(_leaf_gaps(prog["change"], ref["change"],
                                           leaves).max()),
            "grad_gap_geomean": float(np.exp(np.mean(np.log(
                np.maximum(grad, 1e-12)))))}


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaf that sets each leaf number (for the readings' notes)."""
    g_ref = ref["grad1"]
    med = float(np.median(list(g_ref.values())))
    out = {}
    for key in ("grad1", "change"):
        m = float(np.median([ref[key][k] for k in g_ref]))
        out[key] = max((k for k, v in g_ref.items()
                        if v >= SILENT_LEAF * med),
                       key=lambda k: abs(prog[key][k] - ref[key][k])
                       / max(ref[key][k], m, 1e-30))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; no limits, no verdict of correct."""
    return bool(limits) and all(np.isfinite(numbers[k])
                                and numbers[k] <= limits[k] for k in limits)


def check_lines(numbers: Dict[str, float],
                limits: Dict[str, float]) -> List[str]:
    return [f"check {k}: {numbers[k]!r} limit {limits[k]!r}"
            for k in limits]
