"""The drill's metrics plane: windowed online AUC and staleness summaries.

Numpy-only (no torch) so the feedback layer stays importable in light
processes. The AUC here is the exact Mann-Whitney statistic with midrank
tie handling, in float64 numpy, so it equals the JAX package's
``loop.metrics`` bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def exact_auc(probs: Sequence[float], labels: Sequence[float]) -> float:
    """Exact ROC AUC (midranks for ties); NaN when one class is absent."""
    p = np.asarray(probs, np.float64)
    y = np.asarray(labels, np.float64) > 0.5
    n_pos = int(y.sum())
    n_neg = int(y.size - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(p.size, np.float64)
    sorted_p = p[order]
    i = 0
    while i < p.size:
        j = i
        while j + 1 < p.size and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0  # midrank, 1-based
        i = j + 1
    rank_sum_pos = float(ranks[y].sum())
    return (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def windowed_auc(samples: List[Tuple[float, float, float, float]],
                 n_windows: int, duration_s: float) -> List[Dict[str, Any]]:
    """Windowed online-vs-frozen AUC over ``(t_s, label, online_prob,
    baseline_prob)`` samples: the metric production watches to see the
    online model pull away from (or regress against) the frozen baseline.
    Windows split logical time evenly over ``[0, duration_s]``."""
    out = []
    for w in range(int(n_windows)):
        lo = duration_s * w / n_windows
        hi = duration_s * (w + 1) / n_windows
        in_w = [s for s in samples if lo <= s[0] < hi]
        labels = [s[1] for s in in_w]
        entry = {
            "window": w,
            "t_range_s": [round(lo, 3), round(hi, 3)],
            "n": len(in_w),
            "positives": int(sum(1 for y in labels if y > 0.5)),
            "auc_online": None,
            "auc_frozen_baseline": None,
        }
        if in_w:
            a_on = exact_auc([s[2] for s in in_w], labels)
            a_base = exact_auc([s[3] for s in in_w], labels)
            entry["auc_online"] = (round(a_on, 4)
                                   if a_on == a_on else None)
            entry["auc_frozen_baseline"] = (round(a_base, 4)
                                            if a_base == a_base else None)
        out.append(entry)
    return out


def arm_health(samples: Sequence[Tuple[int, float, float, float]]
               ) -> Dict[int, Dict[str, Any]]:
    """Per-arm guardrail metrics over ``(arm, label, prob, latency_ms)``
    samples — the health window the promotion controller judges
    (``train.promote.evaluate_gates``).

    Per arm: ``n``, ``auc`` (exact, None on a one-class window),
    ``p99_latency_ms``, ``nonfinite`` (count of NaN/Inf probs — those rows
    are EXCLUDED from auc/calibration so one poisoned prediction cannot
    also poison the other gates), ``mean_pred`` / ``observed_ctr`` /
    ``calibration_err`` (|mean predicted − observed CTR|).

    Deterministic and representation-stable: inputs are cast to float64
    from whatever the caller logged (the impression log stamps float32
    preds), sums run in sorted-sample order as given, and every reported
    float is rounded — so the online accumulation and a pure offline
    recomputation from the impression log produce bit-identical dicts.
    """
    by_arm: Dict[int, List[Tuple[float, float, float]]] = {}
    for arm, label, prob, latency_ms in samples:
        by_arm.setdefault(int(arm), []).append(
            (float(label), float(prob), float(latency_ms)))
    out: Dict[int, Dict[str, Any]] = {}
    for arm in sorted(by_arm):
        rows = by_arm[arm]
        probs = np.asarray([r[1] for r in rows], np.float64)
        labels = np.asarray([r[0] for r in rows], np.float64)
        lats = [r[2] for r in rows]
        finite = np.isfinite(probs)
        nonfinite = int(probs.size - int(finite.sum()))
        fp, fl = probs[finite], labels[finite]
        auc = exact_auc(fp, fl) if fp.size else float("nan")
        mean_pred = float(fp.mean()) if fp.size else None
        ctr = float(fl.mean()) if fl.size else None
        p99 = percentile(lats, 99)
        out[arm] = {
            "arm": arm,
            "n": len(rows),
            "auc": round(auc, 4) if auc == auc else None,
            "p99_latency_ms": round(p99, 3) if p99 is not None else None,
            "nonfinite": nonfinite,
            "mean_pred": (round(mean_pred, 6)
                          if mean_pred is not None else None),
            "observed_ctr": round(ctr, 6) if ctr is not None else None,
            "calibration_err": (round(abs(mean_pred - ctr), 6)
                                if mean_pred is not None and ctr is not None
                                else None),
        }
    return out


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def staleness_summary(staleness_s: Sequence[float]) -> Dict[str, Any]:
    """p50/p95/max of end-to-end staleness samples (impression served ->
    first servable model that trained on it), in seconds."""
    return {
        "n": int(len(staleness_s)),
        "staleness_p50_s": (round(percentile(staleness_s, 50), 3)
                            if len(staleness_s) else None),
        "staleness_p95_s": (round(percentile(staleness_s, 95), 3)
                            if len(staleness_s) else None),
        "staleness_max_s": (round(float(max(staleness_s)), 3)
                            if len(staleness_s) else None),
    }
