"""Seeded diurnal traffic: a precomputed, bit-replayable request plan.

Production request rates are day-shaped; a drill that only ever sees a flat
rate never exercises the batcher's two regimes (deadline-bound at the
trough, max-batch-bound at the peak). The plan compresses one "day" into
``duration_s``: request arrivals follow a nonhomogeneous Poisson process
with rate ``base_qps + (peak_qps - base_qps) * sin^2(pi * t / duration)``
(trough at both ends, peak mid-run — the chaos schedule's 20-80% event
window lands its faults on the peak).

Everything — arrival times, request sizes, feature arrays, ground-truth
labels — is drawn up front from one seed, so two plans with equal seeds are
element-for-element identical and a drill replay serves byte-identical
traffic. Labels follow the same hidden-logistic model as
``libsvm.generate_synthetic_ctr`` (``hidden_seed`` fixes the ground truth
independently of the traffic seed), drawn per-impression from a
``(seed, impression_id)``-keyed rng — deterministic even if requests are
served out of order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlannedRequest:
    t_s: float            # scheduled submit time, seconds from plan start
    first_id: int         # impression id of row 0 (rows are consecutive)
    ids: np.ndarray       # [n, F] int32 — exactly what serving scores
    vals: np.ndarray      # [n, F] float32
    labels: np.ndarray    # [n] float32 ground truth (known to the drill,
    #                       revealed to the joiner only after the delay)


class DiurnalTrafficPlan:
    """Precomputed request schedule + hidden-model ground truth."""

    def __init__(self, seed: int, *, duration_s: float, base_qps: float,
                 peak_qps: float, feature_size: int, field_size: int,
                 max_rows: int = 8, hidden_seed: int = 12345):
        if peak_qps < base_qps or base_qps <= 0:
            raise ValueError(
                f"need 0 < base_qps <= peak_qps, got {base_qps}/{peak_qps}")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.hidden_w = np.random.default_rng(hidden_seed).normal(
            0, 1.0, size=feature_size).astype(np.float32)
        rng = np.random.default_rng(self.seed)
        requests: List[PlannedRequest] = []
        t, next_id = 0.0, 0
        while True:
            # Thinning (Lewis-Shedler): candidate arrivals at the peak
            # rate, accepted with probability rate(t)/peak — exact for a
            # nonhomogeneous Poisson process, and fully seeded.
            t += float(rng.exponential(1.0 / peak_qps))
            if t >= self.duration_s:
                break
            rate = base_qps + (peak_qps - base_qps) * (
                math.sin(math.pi * t / self.duration_s) ** 2)
            if float(rng.random()) >= rate / peak_qps:
                continue
            n = int(rng.integers(1, max_rows + 1))
            ids = rng.integers(0, feature_size,
                               (n, field_size)).astype(np.int32)
            vals = rng.normal(size=(n, field_size)).astype(np.float32)
            labels = np.empty((n,), np.float32)
            for r in range(n):
                labels[r] = self._draw_label(next_id + r, ids[r], vals[r])
            requests.append(PlannedRequest(
                t_s=round(t, 6), first_id=next_id,
                ids=ids, vals=vals, labels=labels))
            next_id += n
        self.requests: Tuple[PlannedRequest, ...] = tuple(requests)
        self.total_rows = next_id

    def _draw_label(self, impression_id: int, ids: np.ndarray,
                    vals: np.ndarray) -> float:
        logit = float(np.dot(self.hidden_w[ids], vals)) * 0.5
        p = 1.0 / (1.0 + math.exp(-logit))
        u = np.random.default_rng(
            (self.seed + 1) * 2_654_435_761 + int(impression_id)).random()
        return float(u < p)

    def fingerprint_data(self) -> Tuple:
        """Deterministic digestable view (times, ids, labels) for audit
        fingerprints."""
        return tuple((r.t_s, r.first_id, int(r.ids.shape[0]),
                      r.labels.tobytes()) for r in self.requests)


# --------------------------------------------------------------------------
# Flood traffic: a million-user Zipf population driven past saturation.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FloodRequest:
    t_s: float            # scheduled submit time, seconds from plan start
    user_id: int          # population index (0 = most active); the sticky
    #                       affinity key and history owner
    value: str            # admission value class (serve/admission.py)
    first_id: int         # impression id of row 0
    ids: np.ndarray       # [n, F] int32
    vals: np.ndarray      # [n, F] float32
    hist_ids: np.ndarray  # [L] int32 — the user's click history BEFORE
    #                       this request (per-user continuity)
    hist_mask: np.ndarray  # [L] float32


class ZipfUserPopulation:
    """>= 1M synthetic users with Zipf-distributed activity and per-user
    click-history continuity.

    User activity follows ``rank^-zipf_q`` (user 0 is the hottest head
    user); item popularity follows its own Zipf over ``item_vocab`` ids, so
    DIN/BST and the twin-tower index see realistic skew: head users
    accumulate long histories across requests, tail users mostly arrive
    cold. Sampling is a vectorized inverse-CDF (``searchsorted`` over a
    precomputed float64 cumsum — ~8 MB per million users, built once);
    histories are LAZY per-user deques so a million-user population costs
    memory only for the users traffic actually touched.
    """

    def __init__(self, seed: int, *, users: int = 1_000_000,
                 zipf_q: float = 1.1, item_vocab: int = 10_000,
                 item_zipf_q: float = 1.05, hist_len: int = 8):
        if users < 1 or item_vocab < 1:
            raise ValueError(
                f"need users/item_vocab >= 1, got {users}/{item_vocab}")
        self.seed = int(seed)
        self.users = int(users)
        self.zipf_q = float(zipf_q)
        self.item_vocab = int(item_vocab)
        self.hist_len = int(hist_len)
        w = np.arange(1, self.users + 1, dtype=np.float64) ** -zipf_q
        self._user_cum = np.cumsum(w)
        self._user_cum /= self._user_cum[-1]
        wi = np.arange(1, self.item_vocab + 1,
                       dtype=np.float64) ** -float(item_zipf_q)
        self._item_cum = np.cumsum(wi)
        self._item_cum /= self._item_cum[-1]
        self._hist: dict = {}     # user_id -> List[int], most recent last

    def sample_users(self, rng: np.random.Generator,
                     count: int) -> np.ndarray:
        """``count`` user ids by inverse CDF (0 = most active)."""
        return np.searchsorted(self._user_cum, rng.random(count),
                               side="right").astype(np.int64)

    def sample_items(self, rng: np.random.Generator,
                     count: int) -> np.ndarray:
        return np.searchsorted(self._item_cum, rng.random(count),
                               side="right").astype(np.int64)

    @property
    def touched_users(self) -> int:
        """How many distinct users have any history (lazy-store size)."""
        return len(self._hist)

    def history(self, user_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(hist_ids [L], hist_mask [L]) — most recent clicks, zero-padded
        at the tail like the cascade's ``_fit_history`` convention."""
        clicks = self._hist.get(int(user_id), ())
        out_ids = np.zeros((self.hist_len,), np.int32)
        out_mask = np.zeros((self.hist_len,), np.float32)
        n = min(len(clicks), self.hist_len)
        if n:
            out_ids[:n] = clicks[-n:]
            out_mask[:n] = 1.0
        return out_ids, out_mask

    def click(self, user_id: int, item_id: int) -> None:
        """Append one click to the user's history (bounded at hist_len)."""
        hist = self._hist.setdefault(int(user_id), [])
        hist.append(int(item_id))
        if len(hist) > self.hist_len:
            del hist[:len(hist) - self.hist_len]


class FloodTrafficPlan:
    """Open-loop flood schedule: a FIXED offered rate (Poisson arrivals at
    ``offered_qps``), each request drawn from a shared
    :class:`ZipfUserPopulation` with a seeded value class — the load shape
    for driving a fleet PAST saturation, where a closed-loop client would
    self-throttle and hide the knee.

    The population is shared (and mutated: every planned request appends
    its item to the user's history), so sweeping multiple plans over one
    population carries history continuity across offered-load points.
    Construction order is the determinism contract: building the same
    plans in the same order from a fresh same-seed population reproduces
    identical traffic (``fingerprint_data``).

    ``repeat_p`` > 0 makes each returning user REPLAY their previous
    request byte-identically with that probability (same ids/vals/history
    arrays, no history mutation) — the workload shape the serving result
    cache and in-flight coalescing monetize. Fresh randoms never produce
    byte-identical requests, so without this knob a flood cannot exercise
    the fast path at all. ``repeat_p=0`` (the default) draws NOTHING extra
    from the rng stream: existing plans reproduce bit-identically.
    """

    #: seeded value-class mix (lowest value first; must sum to 1)
    VALUE_MIX: Tuple[Tuple[str, float], ...] = (
        ("bulk", 0.3), ("normal", 0.6), ("critical", 0.1))

    def __init__(self, seed: int, *, offered_qps: float, duration_s: float,
                 population: ZipfUserPopulation,
                 field_size: int, feature_size: int, max_rows: int = 1,
                 repeat_p: float = 0.0):
        if offered_qps <= 0 or duration_s <= 0:
            raise ValueError(
                f"need positive offered_qps/duration_s, got "
                f"{offered_qps}/{duration_s}")
        if not 0.0 <= repeat_p < 1.0:
            raise ValueError(
                f"repeat_p must be in [0, 1), got {repeat_p}")
        self.seed = int(seed)
        self.offered_qps = float(offered_qps)
        self.duration_s = float(duration_s)
        self.repeat_p = float(repeat_p)
        self.population = population
        rng = np.random.default_rng(self.seed)
        classes = [c for c, _ in self.VALUE_MIX]
        probs = np.asarray([p for _, p in self.VALUE_MIX])
        requests: List[FloodRequest] = []
        last: dict = {}   # user -> (ids, vals, hist_ids, hist_mask)
        repeats = 0
        t, next_id = 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / self.offered_qps))
            if t >= self.duration_s:
                break
            user = int(population.sample_users(rng, 1)[0])
            value = classes[int(rng.choice(len(classes), p=probs))]
            prev = last.get(user) if self.repeat_p > 0 else None
            if prev is not None and float(rng.random()) < self.repeat_p:
                # Byte-identical replay of this user's previous request:
                # same arrays, same history, NO click (the replay is the
                # same impression, not a new one).
                ids, vals, hist_ids, hist_mask = prev
                requests.append(FloodRequest(
                    t_s=round(t, 6), user_id=user, value=value,
                    first_id=next_id, ids=ids, vals=vals,
                    hist_ids=hist_ids, hist_mask=hist_mask))
                next_id += int(ids.shape[0])
                repeats += 1
                continue
            item = int(population.sample_items(rng, 1)[0]) \
                % max(1, feature_size)
            n = int(rng.integers(1, max_rows + 1)) if max_rows > 1 else 1
            ids = rng.integers(0, feature_size,
                               (n, field_size)).astype(np.int32)
            ids[:, 0] = item
            vals = rng.normal(size=(n, field_size)).astype(np.float32)
            hist_ids, hist_mask = population.history(user)
            requests.append(FloodRequest(
                t_s=round(t, 6), user_id=user, value=value,
                first_id=next_id, ids=ids, vals=vals,
                hist_ids=hist_ids, hist_mask=hist_mask))
            population.click(user, item)
            next_id += n
            if self.repeat_p > 0:
                last[user] = (ids, vals, hist_ids, hist_mask)
        self.requests: Tuple[FloodRequest, ...] = tuple(requests)
        self.total_rows = next_id
        self.repeat_requests = repeats

    def fingerprint_data(self) -> Tuple:
        """Deterministic digestable view for audit fingerprints."""
        return tuple(
            (r.t_s, r.user_id, r.value, r.first_id, r.ids.tobytes(),
             r.hist_ids.tobytes()) for r in self.requests)
