"""Streaming evaluation metrics (port of ``deepfm_tpu.train.metrics``).

The binned AUC of ``tf.metrics.auc``: a pair of float32 histograms of the
predicted probability, split by label, over ``num_bins`` equal bins, and
the trapezoidal ROC area swept across the bin thresholds. The state is
additive, so batches merge by summing. Bin counts are integers held in
float32 (exact below 2**24 per bin), so they equal the JAX package's on
the same probabilities whatever the order of the sums.

Everything stays on the device of the inputs; only ``float()`` of a result
reads it back. Under data parallelism each rank accumulates its own
shard's histograms and loss sums; :func:`auc_psum` and :func:`mean_psum`
sum them over the data ranks (one all_reduce each) before the compute. :class:`WindowedAuc` is the online trainer's sliding-window
AUC over host arrays, and :class:`WindowedAucDict` one window per task.
"""

from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class AucState(NamedTuple):
    """Histogram of prediction scores split by label."""
    pos: torch.Tensor  # float32 [num_bins]
    neg: torch.Tensor  # float32 [num_bins]


def auc_init(num_bins: int = 200, *, device=None) -> AucState:
    return AucState(pos=torch.zeros((num_bins,), device=device),
                    neg=torch.zeros((num_bins,), device=device))


def auc_update(state: AucState, probs: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> AucState:
    """Accumulate a batch. probs/labels: [B] or [B,1] in [0,1]."""
    num_bins = state.pos.shape[0]
    probs = probs.reshape(-1).float()
    labels = labels.reshape(-1).float()
    w = (torch.ones_like(probs) if weights is None
         else weights.reshape(-1).float())
    bins = torch.clamp((probs * num_bins).to(torch.int32), 0,
                       num_bins - 1).long()
    pos = state.pos + torch.zeros_like(state.pos).index_add_(
        0, bins, w * labels)
    neg = state.neg + torch.zeros_like(state.neg).index_add_(
        0, bins, w * (1.0 - labels))
    return AucState(pos=pos, neg=neg)


def auc_merge(a: AucState, b: AucState) -> AucState:
    return AucState(pos=a.pos + b.pos, neg=a.neg + b.neg)


def _all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    import torch.distributed as dist  # noqa: PLC0415
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def auc_psum(state: AucState, group=None) -> AucState:
    """The histograms summed over the data ranks (the JAX ``psum``): one
    all_reduce of the stacked pair. Bin counts are integers in float32,
    so the sum is exact in any order below 2**24 per bin."""
    both = _all_reduce_sum(torch.stack([state.pos, state.neg]), group)
    return AucState(pos=both[0], neg=both[1])


def auc_compute(state: AucState) -> torch.Tensor:
    """Trapezoidal AUC over the ROC curve swept across bin thresholds.

    Threshold k = "predict positive iff score >= bin k"; TPR/FPR from suffix
    sums of the histograms. NaN when either class is empty: undefined is
    reported as undefined, never as 0.0 or 0.5."""
    total_pos = torch.sum(state.pos)
    total_neg = torch.sum(state.neg)
    zero = state.pos.new_zeros((1,))
    tp = torch.cat([torch.flip(torch.cumsum(torch.flip(state.pos, [0]), 0),
                               [0]), zero])
    fp = torch.cat([torch.flip(torch.cumsum(torch.flip(state.neg, [0]), 0),
                               [0]), zero])
    tpr = tp / torch.clamp(total_pos, min=1.0)
    fpr = fp / torch.clamp(total_neg, min=1.0)
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) * 0.5)
    return torch.where((total_pos > 0) & (total_neg > 0), auc,
                       torch.full_like(auc, float("nan")))


class MeanState(NamedTuple):
    total: torch.Tensor  # scalar
    count: torch.Tensor  # scalar


def mean_init(*, device=None) -> MeanState:
    return MeanState(total=torch.zeros((), device=device),
                     count=torch.zeros((), device=device))


def mean_compute(state: MeanState) -> torch.Tensor:
    return state.total / torch.clamp(state.count, min=1.0)


def mean_psum(state: MeanState, group=None) -> MeanState:
    """The weighted sum and count summed over the data ranks."""
    both = _all_reduce_sum(torch.stack([state.total, state.count]), group)
    return MeanState(total=both[0], count=both[1])


class WindowedAuc:
    """Sliding-window streaming AUC for the online trainer: "AUC over the
    last ``window_steps`` steps of traffic" rather than a batch job's one
    pass. Each :meth:`update` bins one eval slice into float64 pos/neg
    histograms (host numpy: eval slices arrive as host arrays off the
    predict path) tagged with its training step; slices more than
    ``window_steps`` old are evicted. :meth:`compute` is
    :func:`auc_compute` over the window's histograms in float32."""

    def __init__(self, window_steps: int, num_bins: int = 200):
        if window_steps <= 0:
            raise ValueError(f"window_steps must be > 0, got {window_steps}")
        self.window_steps = int(window_steps)
        self.num_bins = int(num_bins)
        self._slices: "collections.deque" = collections.deque()
        self._pos = np.zeros((self.num_bins,), np.float64)
        self._neg = np.zeros((self.num_bins,), np.float64)
        self.examples = 0  # examples inside the window

    def _hist(self, probs, labels) -> Tuple[np.ndarray, np.ndarray]:
        probs = np.asarray(probs, dtype=np.float64).reshape(-1)
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        bins = np.clip((probs * self.num_bins).astype(np.int64),
                       0, self.num_bins - 1)
        pos = np.bincount(bins, weights=labels, minlength=self.num_bins)
        neg = np.bincount(bins, weights=1.0 - labels,
                          minlength=self.num_bins)
        return pos, neg

    def update(self, step: int, probs, labels) -> None:
        """Fold one eval slice, taken at training ``step``, into the window."""
        pos, neg = self._hist(probs, labels)
        self._slices.append((int(step), pos, neg))
        self._pos += pos
        self._neg += neg
        self.examples += int(pos.sum() + neg.sum())
        self.evict(int(step))

    def evict(self, current_step: int) -> None:
        """Drop slices taken ``window_steps`` or more before the step."""
        floor = int(current_step) - self.window_steps
        while self._slices and self._slices[0][0] <= floor:
            _, pos, neg = self._slices.popleft()
            self._pos -= pos
            self._neg -= neg
            self.examples -= int(pos.sum() + neg.sum())

    def histograms(self) -> Tuple[np.ndarray, np.ndarray]:
        """The window's (pos, neg) histograms."""
        return self._pos.copy(), self._neg.copy()

    def compute(self) -> float:
        """The windowed AUC; NaN while the window is empty or lacks a
        class, as the batch path."""
        return float(auc_compute(AucState(
            pos=torch.as_tensor(self._pos, dtype=torch.float32),
            neg=torch.as_tensor(self._neg, dtype=torch.float32))))


class WindowedAucDict:
    """Per-task :class:`WindowedAuc`: one window per named task.

    ``update`` takes per-task probability and label columns ([B, T] in
    ``task_names`` order, or [B] for one task); ``compute`` returns
    ``{task: windowed_auc}``."""

    def __init__(self, task_names, window_steps: int, num_bins: int = 200):
        self.task_names = tuple(task_names)
        if not self.task_names:
            raise ValueError("task_names must name at least one task")
        self._windows = {t: WindowedAuc(window_steps, num_bins)
                         for t in self.task_names}

    def __getitem__(self, task: str) -> WindowedAuc:
        return self._windows[task]

    @property
    def examples(self) -> int:
        """Examples inside the window (every update feeds every task)."""
        return self._windows[self.task_names[0]].examples

    def update(self, step: int, probs, labels) -> None:
        probs = np.asarray(probs)
        labels = np.asarray(labels)
        if probs.ndim == 1:
            probs = probs[:, None]
        if labels.ndim == 1:
            labels = labels[:, None]
        for i, t in enumerate(self.task_names):
            self._windows[t].update(step, probs[:, i], labels[:, i])

    def compute(self) -> Dict[str, float]:
        return {t: w.compute() for t, w in self._windows.items()}


def auc_numpy_reference(probs, labels) -> float:
    """Exact (rank-based) AUC on the host, ties averaged: the test oracle
    for the binned estimator."""
    probs = np.asarray(probs).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(probs) + 1)
    sorted_p = probs[order]
    i = 0
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
