"""Delayed-label joining: impressions + late labels -> training shards.

The label side of the feedback loop. Clicks (labels) arrive seconds-to-
minutes after the impression was served; the joiner holds each impression
open for ``join_window_s`` of *logical* time, then emits it exactly once:

  * label arrives with delay <= window  -> joined (``labels_joined``);
  * window closes first                 -> emitted with the no-label default
    0.0 — the standard delayed-feedback negative assumption
    (``impressions_expired``);
  * label arrives with delay > window   -> the label is dropped and counted
    (``labels_past_window``), never retroactively applied;
  * duplicate impression id             -> the later copy is dropped
    (``duplicate_impressions``); duplicate or orphan labels count
    ``labels_late``.

All decisions are pure functions of (impression served_at, label arrival,
window) — the caller's pump cadence cannot change a single counter, which
is what makes a chaos drill's audit bit-reproducible across runs.

Emission is transactional and ordered: impression shard ``imp-NNNNN`` maps
to training shard ``<prefix>-NNNNN`` (same index), shards emit strictly in
index order (so the online stream admits them in the order they were
served), and each emission is manifest-sidecar-then-atomic-rename. The
existence of the output shard IS the joiner's durable state: a restarted
joiner skips any shard whose output exists — re-running it would produce
byte-identical output, so crash-between-manifest-and-shard heals by redo —
giving exactly-once emission across supervised restarts with no extra
journal. Torn impression shards (injected faults, torn tails) are healed
mid-join: the intact prefix is processed, the tail discarded and counted.
"""

from __future__ import annotations

import heapq
import json
import os
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data import example_codec, tfrecord
from .health import LoopHealth
from .impressions import iter_impressions


class SeededLabelFeed:
    """Deterministic delayed-label source.

    Each impression's delay is a pure function of ``(seed, impression_id)``
    — NOT of push order or wall time — so the same seed replays the same
    arrival schedule bit-exactly. ``push()`` registers the ground-truth
    label at serve time; ``poll(now)`` delivers every label whose arrival
    time has passed.
    """

    def __init__(self, seed: int, *, delay_min_s: float, delay_max_s: float):
        if delay_max_s < delay_min_s:
            raise ValueError(f"delay_max_s {delay_max_s} < delay_min_s "
                             f"{delay_min_s}")
        self.seed = int(seed)
        self.delay_min_s = float(delay_min_s)
        self.delay_max_s = float(delay_max_s)
        self._heap: List[Tuple[float, int, float]] = []  # (arrival, iid, y)

    def delay_for(self, impression_id: int) -> float:
        rng = random.Random(self.seed * 1_000_003 + int(impression_id))
        return rng.uniform(self.delay_min_s, self.delay_max_s)

    def push(self, impression_id: int, label: float,
             served_at_s: float) -> float:
        """Register a label; returns its (deterministic) arrival time."""
        arrival = float(served_at_s) + self.delay_for(impression_id)
        heapq.heappush(self._heap,
                       (arrival, int(impression_id), float(label)))
        return arrival

    def poll(self, now_s: float) -> List[Tuple[int, float, float]]:
        """-> [(impression_id, label, arrival_s)] for every label whose
        arrival is at or before ``now_s``, in arrival order."""
        out = []
        while self._heap and self._heap[0][0] <= now_s:
            arrival, iid, label = heapq.heappop(self._heap)
            out.append((iid, label, arrival))
        return out

    @property
    def pending(self) -> int:
        return len(self._heap)


class _Record:
    __slots__ = ("iid", "served_at", "ids", "vals", "label", "resolved")

    def __init__(self, iid: int, served_at: float,
                 ids: np.ndarray, vals: np.ndarray):
        self.iid = iid
        self.served_at = served_at
        self.ids = ids
        self.vals = vals
        self.label: Optional[float] = None
        self.resolved = False


class _Shard:
    __slots__ = ("index", "source", "records", "emitted")

    def __init__(self, index: int, source: str):
        self.index = index
        self.source = source
        self.records: List[_Record] = []
        self.emitted = False


_IMP_NAME = re.compile(r"^(?P<prefix>.+)-(?P<index>\d{5})\.tfrecords$")


class DelayedLabelJoiner:
    """Pump-driven joiner: call :meth:`pump` with a monotonically
    non-decreasing logical clock; emitted training-shard paths return."""

    DEFAULT_LABEL = 0.0

    def __init__(self, impression_dir: str, out_dir: str,
                 feed: SeededLabelFeed, *, join_window_s: float,
                 prefix: str = "tr", health: Optional[LoopHealth] = None,
                 verify_crc: bool = True):
        if join_window_s <= 0:
            raise ValueError(f"join_window_s must be > 0, got {join_window_s}")
        self._imp_dir = impression_dir
        self._out_dir = out_dir
        self._feed = feed
        self.join_window_s = float(join_window_s)
        self._prefix = prefix
        self.health = health if health is not None else LoopHealth()
        self._verify_crc = bool(verify_crc)
        os.makedirs(out_dir, exist_ok=True)
        self._ingested: set = set()            # impression shard basenames
        self._shards: Dict[int, _Shard] = {}   # index -> shard
        self._open: Dict[int, _Record] = {}    # iid -> unresolved record
        self._seen: set = set()                # every iid ever ingested
        self._served_at: Dict[int, float] = {}  # iid -> serve time (for the
        #                                         late-label classification)
        self.manifests: Dict[str, List[int]] = {}  # out path -> iid order
        self._next_emit = 0                    # in-order emission cursor

    # -- paths ----------------------------------------------------------
    def _out_path(self, index: int) -> str:
        return os.path.join(self._out_dir,
                            f"{self._prefix}-{index:05d}.tfrecords")

    def _manifest_path(self, index: int) -> str:
        return os.path.join(self._out_dir,
                            f".{self._prefix}-{index:05d}.manifest.json")

    # -- the pump -------------------------------------------------------
    def pump(self, now_s: float) -> List[str]:
        """Ingest new impression shards, apply due labels, expire closed
        windows, emit every fully-resolved shard (in index order).
        Returns the training-shard paths emitted by this call."""
        self._ingest()
        for iid, label, arrival in self._feed.poll(now_s):
            self._apply_label(iid, label, arrival)
        for rec in list(self._open.values()):
            if now_s - rec.served_at > self.join_window_s:
                self._resolve(rec)
        return self._emit_ready()

    def finalize(self, now_s: float) -> List[str]:
        """End of the run: one last pump, then force-expire everything
        still open (their windows would close with no label) and emit."""
        emitted = self.pump(now_s)
        for rec in list(self._open.values()):
            self._resolve(rec)
        return emitted + self._emit_ready()

    # -- internals ------------------------------------------------------
    def _ingest(self) -> None:
        try:
            names = sorted(os.listdir(self._imp_dir))
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(".") or name in self._ingested:
                continue
            m = _IMP_NAME.match(name)
            if m is None:
                continue
            index = int(m.group("index"))
            self._ingested.add(name)
            shard = _Shard(index, name)
            self._shards[index] = shard
            already_emitted = os.path.exists(self._out_path(index))
            for iid, served_at, ids, vals in iter_impressions(
                    os.path.join(self._imp_dir, name),
                    verify_crc=self._verify_crc, health=self.health):
                if iid in self._seen:
                    self.health.record("duplicate_impressions")
                    continue
                self._seen.add(iid)
                self._served_at[iid] = served_at
                rec = _Record(iid, served_at, ids, vals)
                shard.records.append(rec)
                if already_emitted:
                    rec.resolved = True     # durable state: output exists
                else:
                    self._open[iid] = rec
            if already_emitted:
                # Restart recovery: the emission already happened; reload
                # its manifest so audits keep working across the restart.
                shard.emitted = True
                try:
                    with open(self._manifest_path(index),
                              encoding="utf-8") as f:
                        manifest = json.load(f)
                    self.manifests[self._out_path(index)] = [
                        int(i) for i in manifest["impressions"]]
                except (OSError, ValueError, KeyError):
                    pass
                self._next_emit = max(self._next_emit, index + 1)

    def _apply_label(self, iid: int, label: float, arrival: float) -> None:
        rec = self._open.get(iid)
        if rec is not None:
            delay = arrival - rec.served_at
            if delay <= self.join_window_s:
                rec.label = float(label)
                rec.resolved = True
                del self._open[iid]
                self.health.record("labels_joined")
            else:
                self._resolve(rec)
                self.health.record("labels_past_window")
            return
        served = self._served_at.get(iid)
        if served is not None and arrival - served > self.join_window_s:
            # The record was already expired-and-emitted; the label is past
            # the window either way — same counter as the unexpired case,
            # so pump cadence never changes the audit.
            self.health.record("labels_past_window")
        else:
            self.health.record("labels_late")

    def _resolve(self, rec: _Record) -> None:
        """Close a record with the no-label default (delayed-feedback
        negative)."""
        rec.resolved = True
        self._open.pop(rec.iid, None)
        self.health.record("impressions_expired")

    def _emit_ready(self) -> List[str]:
        emitted = []
        while True:
            shard = self._shards.get(self._next_emit)
            if shard is None or shard.emitted \
                    or not all(r.resolved for r in shard.records):
                break
            emitted.append(self._emit(shard))
            self._next_emit += 1
        return emitted

    def _emit(self, shard: _Shard) -> str:
        out_path = self._out_path(shard.index)
        manifest = {
            "source": shard.source,
            "impressions": [r.iid for r in shard.records],
            "labels": [float(r.label if r.label is not None
                             else self.DEFAULT_LABEL)
                       for r in shard.records],
        }
        # Manifest first, shard second; both atomic. A crash between the
        # two redoes this emission from scratch (byte-identical), so the
        # pair is consistent once the shard exists.
        mpath = self._manifest_path(shard.index)
        tmp = mpath + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        tmp_shard = os.path.join(
            self._out_dir, f".{self._prefix}-{shard.index:05d}.part")
        with tfrecord.TFRecordWriter(tmp_shard) as w:
            for rec in shard.records:
                label = (rec.label if rec.label is not None
                         else self.DEFAULT_LABEL)
                w.write(example_codec.encode_ctr_example(
                    label, rec.ids, rec.vals))
        with open(tmp_shard, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp_shard, out_path)
        shard.emitted = True
        self.manifests[out_path] = [r.iid for r in shard.records]
        self.health.record("joined_shards")
        self.health.record("records_emitted", len(shard.records))
        return out_path

    # -- introspection --------------------------------------------------
    @property
    def open_impressions(self) -> int:
        return len(self._open)

    @property
    def emitted_shards(self) -> List[str]:
        return [self._out_path(i) for i, s in sorted(self._shards.items())
                if s.emitted]
