"""Training/serving skew check: one logged record, two decode paths, zero
byte drift.

The classic failure of online CTR systems is silent: the serving path and
the training path disagree about what a feature vector *was* (different
casts, different default fills, different key aliases), AUC decays, and
nothing raises. Here the check is executable: for every audited record, the
feature arrays the serving engine actually scored (kept by the drill) must
be bit-identical to what the TRAINING decoder reads back from the emitted
training shard (``example_codec.decode_ctr_example`` — the golden-pinned
bit-exact mirror of the native decoder the pipeline runs).

"Bit-identical" means: ids equal as integers (serving submits int32, the
on-disk schema is int64 — a value drift, not a width drift, is what skew
is), and vals equal as raw float32 bytes (no tolerance: a single ULP of
drift means the paths diverged).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data import example_codec, tfrecord


class SkewChecker:
    """Audit emitted training shards against the served feature arrays.

    ``served`` maps impression id -> (ids, vals) exactly as submitted to
    the serving engine. Shard record order comes from the joiner's
    manifest sidecar (record k of the shard is impression ``manifest[k]``).
    """

    def __init__(self, served: Dict[int, Tuple[np.ndarray, np.ndarray]]):
        self._served = served
        self.records_audited = 0
        self.mismatches: List[str] = []

    def audit_shard(self, shard_path: str,
                    impression_order: Optional[List[int]] = None) -> int:
        """Audit every record of one emitted shard; returns the number
        audited. Mismatches accumulate in ``self.mismatches`` (empty ==
        bit-identical)."""
        if impression_order is None:
            manifest_path = os.path.join(
                os.path.dirname(shard_path),
                "." + os.path.basename(shard_path).replace(
                    ".tfrecords", ".manifest.json"))
            with open(manifest_path, encoding="utf-8") as f:
                impression_order = [int(i)
                                    for i in json.load(f)["impressions"]]
        k = 0
        for rec in tfrecord.iter_records(shard_path):
            if k >= len(impression_order):
                self.mismatches.append(
                    f"{shard_path}: record {k} beyond manifest "
                    f"({len(impression_order)} entries)")
                break
            iid = impression_order[k]
            served = self._served.get(iid)
            if served is None:
                self.mismatches.append(
                    f"{shard_path}[{k}]: impression {iid} never served")
                k += 1
                continue
            s_ids, s_vals = served
            feats = example_codec.decode_example(rec)
            t_label = feats[example_codec.LABEL_KEY]
            t_ids = np.asarray(feats[example_codec.IDS_KEY], np.int64)
            t_vals = np.asarray(feats[example_codec.VALS_KEY], np.float32)
            if not np.array_equal(np.asarray(s_ids, np.int64), t_ids):
                self.mismatches.append(
                    f"{shard_path}[{k}] impression {iid}: ids drifted "
                    f"(served {np.asarray(s_ids).tolist()}, "
                    f"decoded {t_ids.tolist()})")
            elif np.asarray(s_vals, np.float32).tobytes() != t_vals.tobytes():
                self.mismatches.append(
                    f"{shard_path}[{k}] impression {iid}: vals drifted "
                    f"(float32 bytes differ)")
            else:
                # Also cross-check the fixed-schema fast path the pipeline
                # actually calls — the two training decoders must agree
                # with each other AND with serving.
                label2, ids2, vals2 = example_codec.decode_ctr_example(
                    rec, int(t_ids.shape[0]))
                if (not np.array_equal(ids2, t_ids)
                        or vals2.tobytes() != t_vals.tobytes()
                        or label2 != float(np.asarray(t_label)[0])):
                    self.mismatches.append(
                        f"{shard_path}[{k}]: generic and fixed-schema "
                        "decoders disagree")
            self.records_audited += 1
            k += 1
        if k < len(impression_order):
            self.mismatches.append(
                f"{shard_path}: {len(impression_order) - k} manifest "
                "entries have no record")
        return k

    @property
    def ok(self) -> bool:
        return not self.mismatches and self.records_audited > 0
