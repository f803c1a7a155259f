"""Impression logging: served requests written back as TFRecord shards.

The serving side of the feedback loop. Every served row becomes one
impression record — the *exact* feature arrays the model scored (the joiner
re-encodes them unchanged into training shards, which is what makes the
training/serving skew check meaningful: one byte path, end to end).

Shards are produced the only way the online stream source accepts: full
write to a dot-prefixed temp name in the target directory, fsync, then
``os.replace`` — a reader never sees a half-written shard, and shard names
ascend (``imp-00000.tfrecords``, ...) so downstream join order is the log
order.

Record schema = the CTR training schema (``label``/``ids``/``values``) plus
two loop-only keys the joiner strips: ``impression_id`` (int64, unique per
row) and ``served_at_us`` (int64 microseconds on the caller's clock —
logical drill time or wall time, the logger does not care). The placeholder
label is 0.0 until the joiner attaches the real one.

Correlation (obs.trace): callers may additionally stamp ``trace_id`` (the
request's correlation id) and ``model_version`` (the publish version that
scored the row). Both are optional int64 keys — ``decode_impression`` reads
only the required keys, and the joiner re-encodes just label/ids/values, so
stamped shards stay byte-compatible downstream.

Experimentation (serve.experiment): two more optional keys ride the same
pattern — ``arm`` (int64: 0 control / 1 challenger, the traffic-split arm
that produced the row; shadow-lane challenger responses are logged under
their own impression ids with arm=1) and ``pred`` (float32: the probability
the arm's model served). ``pred`` is what makes per-arm health replayable
from the log alone: offline recomputation of AUC/calibration from
(arm, pred, joined label) must match the online accumulation bit-exactly,
no model re-run required.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data import example_codec, tfrecord
from .health import LoopHealth

IMPRESSION_ID_KEY = "impression_id"
SERVED_AT_KEY = "served_at_us"
TRACE_ID_KEY = "trace_id"
MODEL_VERSION_KEY = "model_version"
ARM_KEY = "arm"
PRED_KEY = "pred"


def encode_impression(impression_id: int, served_at_s: float,
                      ids: np.ndarray, vals: np.ndarray, *,
                      trace_id: Optional[int] = None,
                      model_version: Optional[int] = None,
                      arm: Optional[int] = None,
                      pred: Optional[float] = None) -> bytes:
    features = {
        example_codec.LABEL_KEY: (np.asarray([0.0], np.float32), "float"),
        example_codec.IDS_KEY: (np.asarray(ids, np.int64), "int64"),
        example_codec.VALS_KEY: (np.asarray(vals, np.float32), "float"),
        IMPRESSION_ID_KEY: (
            np.asarray([int(impression_id)], np.int64), "int64"),
        SERVED_AT_KEY: (
            np.asarray([int(round(served_at_s * 1e6))], np.int64), "int64"),
    }
    if trace_id is not None:
        features[TRACE_ID_KEY] = (
            np.asarray([int(trace_id)], np.int64), "int64")
    if model_version is not None:
        features[MODEL_VERSION_KEY] = (
            np.asarray([int(model_version)], np.int64), "int64")
    if arm is not None:
        features[ARM_KEY] = (np.asarray([int(arm)], np.int64), "int64")
    if pred is not None:
        features[PRED_KEY] = (np.asarray([pred], np.float32), "float")
    return example_codec.encode_example(features)


def read_correlation(buf: bytes) -> Tuple[Optional[int], Optional[int]]:
    """-> (trace_id, model_version) of one impression record (None when the
    writer did not stamp them)."""
    feats = example_codec.decode_example(buf)
    out = []
    for key in (TRACE_ID_KEY, MODEL_VERSION_KEY):
        entry = feats.get(key)
        out.append(None if entry is None else int(np.asarray(entry)[0]))
    return out[0], out[1]


def read_experiment(buf: bytes) -> Tuple[Optional[int], Optional[float]]:
    """-> (arm, pred) of one impression record (None when the writer did
    not stamp them). ``pred`` comes back as the float32 the arm served —
    the exact value per-arm health recomputation must use."""
    feats = example_codec.decode_example(buf)
    arm_entry = feats.get(ARM_KEY)
    pred_entry = feats.get(PRED_KEY)
    arm = None if arm_entry is None else int(np.asarray(arm_entry)[0])
    pred = (None if pred_entry is None
            else float(np.asarray(pred_entry, np.float32)[0]))
    return arm, pred


def decode_impression(buf: bytes) -> Tuple[int, float, np.ndarray, np.ndarray]:
    """-> (impression_id, served_at_s, ids int64[F], vals float32[F])."""
    feats = example_codec.decode_example(buf)
    try:
        iid = feats[IMPRESSION_ID_KEY]
        at_us = feats[SERVED_AT_KEY]
        ids = feats[example_codec.IDS_KEY]
        vals = feats[example_codec.VALS_KEY]
    except KeyError:
        raise ValueError(
            f"not an impression record: found keys {sorted(feats)}") from None
    return (int(np.asarray(iid)[0]), float(np.asarray(at_us)[0]) / 1e6,
            np.asarray(ids, np.int64), np.asarray(vals, np.float32))


def iter_impressions(path: str, *, verify_crc: bool = True,
                     health: Optional[LoopHealth] = None
                     ) -> Iterator[Tuple[int, float, np.ndarray, np.ndarray]]:
    """Decode one impression shard; a torn tail is healed (intact prefix
    yielded, tail discarded, ``torn_impression_shards`` counted)."""
    from ..data import health as health_lib
    policy = health_lib.BadRecordPolicy("skip")
    for rec in tfrecord.iter_records(path, verify_crc=verify_crc,
                                     policy=policy):
        yield decode_impression(rec)
    if policy.skips and health is not None:
        health.record("torn_impression_shards")


class ImpressionLogger:
    """Append impressions; publish a shard via atomic rename every
    ``shard_records`` rows (and on :meth:`flush`/:meth:`close`)."""

    def __init__(self, out_dir: str, *, shard_records: int = 64,
                 prefix: str = "imp", health: Optional[LoopHealth] = None):
        if shard_records < 1:
            raise ValueError(f"shard_records must be >= 1, got {shard_records}")
        os.makedirs(out_dir, exist_ok=True)
        self._dir = out_dir
        self._shard_records = int(shard_records)
        self._prefix = prefix
        self.health = health if health is not None else LoopHealth()
        self._index = self._next_free_index()
        self._writer: Optional[tfrecord.TFRecordWriter] = None
        self._tmp_path: Optional[str] = None
        self._in_shard = 0
        self.shards: List[str] = []     # final paths, publish order

    def _next_free_index(self) -> int:
        idx = 0
        while os.path.exists(self._final_path(idx)):
            idx += 1
        return idx

    def _final_path(self, idx: int) -> str:
        return os.path.join(self._dir, f"{self._prefix}-{idx:05d}.tfrecords")

    def log(self, impression_id: int, ids: np.ndarray, vals: np.ndarray,
            served_at_s: float, *, trace_id: Optional[int] = None,
            model_version: Optional[int] = None,
            arm: Optional[int] = None,
            pred: Optional[float] = None) -> None:
        """Log one served row. ``ids``/``vals`` are the arrays the engine
        scored ([F], any integer/float32 dtype)."""
        if self._writer is None:
            self._tmp_path = os.path.join(
                self._dir, f".{self._prefix}-{self._index:05d}.part")
            self._writer = tfrecord.TFRecordWriter(self._tmp_path)
            self._in_shard = 0
        self._writer.write(
            encode_impression(impression_id, served_at_s, ids, vals,
                              trace_id=trace_id,
                              model_version=model_version,
                              arm=arm, pred=pred))
        self._in_shard += 1
        self.health.record("impressions_logged")
        if self._in_shard >= self._shard_records:
            self.flush()

    def log_request(self, first_id: int, ids: np.ndarray, vals: np.ndarray,
                    served_at_s: float, *,
                    trace_id: Optional[int] = None,
                    model_version: Optional[int] = None,
                    arm: Optional[int] = None,
                    preds: Optional[np.ndarray] = None) -> List[int]:
        """Log every row of one request ``(ids[n,F], vals[n,F])`` with
        consecutive impression ids starting at ``first_id``; returns them.
        ``trace_id``/``model_version``/``arm`` stamp every row of the
        request (the engine resolves one model version per flush; the
        router one arm per request); ``preds`` ([n] probabilities) stamps
        each row with the probability its arm served."""
        out = []
        for r in range(int(ids.shape[0])):
            iid = int(first_id) + r
            self.log(iid, ids[r], vals[r], served_at_s,
                     trace_id=trace_id, model_version=model_version,
                     arm=arm,
                     pred=None if preds is None else float(preds[r]))
            out.append(iid)
        return out

    def flush(self) -> Optional[str]:
        """Seal the open shard: fsync, atomic rename, return the final path
        (None when nothing is buffered)."""
        if self._writer is None:
            return None
        self._writer.flush()
        with open(self._tmp_path, "rb") as f:
            os.fsync(f.fileno())
        self._writer.close()
        final = self._final_path(self._index)
        os.replace(self._tmp_path, final)
        self._writer, self._tmp_path = None, None
        self._index += 1
        self.shards.append(final)
        self.health.record("impression_shards")
        return final

    def close(self) -> Optional[str]:
        return self.flush()

    def __enter__(self) -> "ImpressionLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
