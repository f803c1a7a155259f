"""LibSVM text <-> TFRecord conversion and the synthetic CTR generator.

The port's copy of ``deepfm_tpu.data.libsvm``: each LibSVM line
``"label id:val id:val ..."`` becomes one ``Example{label: float,
ids: int64[F], values: float[F]}``; the converter shards its output on
request, and ``tfrecord_to_libsvm`` is the reverse path for round trips.
``generate_synthetic_ctr`` writes the same bytes as the JAX package's for
the same arguments, with the optional ``label2`` and history keys.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from . import example_codec, tfrecord


def parse_libsvm_line(line: str) -> Tuple[float, np.ndarray, np.ndarray]:
    parts = line.strip().split()
    if not parts:
        raise ValueError("empty LibSVM line")
    label = float(parts[0])
    ids = np.empty(len(parts) - 1, dtype=np.int64)
    vals = np.empty(len(parts) - 1, dtype=np.float32)
    for i, tok in enumerate(parts[1:]):
        k, _, v = tok.partition(":")
        ids[i] = int(k)
        vals[i] = float(v)
    return label, ids, vals


def format_libsvm_line(label: float, ids: np.ndarray,
                       vals: np.ndarray) -> str:
    toks = [f"{label:g}"] + [f"{int(i)}:{float(v):g}"
                             for i, v in zip(ids, vals)]
    return " ".join(toks)


def convert_libsvm_file(in_path: str, out_path: str, *,
                        field_size: Optional[int] = None,
                        num_shards: int = 1) -> int:
    """Convert a LibSVM text file to TFRecord file(s); returns the record
    count. With ``num_shards > 1`` the records go round-robin into
    ``{out_path}-00000-of-0000N`` shards. ``out_path`` may be a remote URL
    (the fileio seam)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if num_shards == 1:
        writers = [tfrecord.TFRecordWriter(out_path)]
    else:
        writers = [tfrecord.TFRecordWriter(
            f"{out_path}-{s:05d}-of-{num_shards:05d}")
            for s in range(num_shards)]
    n = 0
    try:
        with open(in_path, "r") as f:
            for line in f:
                if not line.strip():
                    continue
                label, ids, vals = parse_libsvm_line(line)
                if field_size is not None and ids.shape[0] != field_size:
                    raise ValueError(f"line {n}: expected {field_size} "
                                     f"features, got {ids.shape[0]}")
                writers[n % num_shards].write(
                    example_codec.encode_ctr_example(label, ids, vals))
                n += 1
    finally:
        for w in writers:
            w.close()
    return n


def tfrecord_to_libsvm(in_path: str, out_path: str, field_size: int) -> int:
    """The reverse conversion, for round trips; returns the record count."""
    n = 0
    with open(out_path, "w") as out:
        for rec in tfrecord.iter_records(in_path):
            label, ids, vals = example_codec.decode_ctr_example(rec,
                                                                field_size)
            out.write(format_libsvm_line(label, ids, vals) + "\n")
            n += 1
    return n


def generate_synthetic_ctr(out_dir: str, *, num_files: int,
                           examples_per_file: int, feature_size: int,
                           field_size: int, prefix: str = "tr",
                           seed: int = 0, hidden_seed: int = 12345,
                           num_labels: int = 1, history: int = 0
                           ) -> List[str]:
    """Write synthetic Criteo-shaped TFRecords with a learnable signal,
    byte-identical to the JAX package's generator for the same arguments.

    Labels follow a logistic model over a hidden random weight vector
    (fixed by ``hidden_seed``, independently of the example sampler's
    ``seed``), so train/eval splits made with different seeds share one
    ground truth and AUC above 0.5 is reachable. ``num_labels=2`` adds a
    click-gated ``label2`` (conversion) from a second hidden vector.
    ``history > 0`` adds a ragged ``hist_ids``/``hist_vals`` pair of
    0..``history`` ids drawn from a rolling pool of clicked ids (early
    records have none), with a history/candidate affinity term in the
    click logit. The defaults draw nothing extra."""
    if num_labels not in (1, 2):
        raise ValueError(f"num_labels must be 1 or 2, got {num_labels}")
    if history < 0:
        raise ValueError(f"history must be >= 0, got {history}")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    hidden_w = np.random.default_rng(hidden_seed).normal(
        0, 1.0, size=feature_size).astype(np.float32)
    hidden_w2 = np.random.default_rng(hidden_seed + 1).normal(
        0, 1.0, size=feature_size).astype(np.float32)
    clicked_pool: List[int] = []
    paths = []
    for fi in range(num_files):
        path = os.path.join(out_dir, f"{prefix}_{fi:04d}.tfrecords")
        paths.append(path)
        with tfrecord.TFRecordWriter(path) as w:
            for _ in range(examples_per_file):
                ids = rng.integers(0, feature_size, size=field_size,
                                   dtype=np.int64)
                vals = rng.normal(0, 1, size=field_size).astype(np.float32)
                logit = float(np.dot(hidden_w[ids], vals)) * 0.5
                hist_ids = None
                if history > 0:
                    hist_n = min(int(rng.integers(0, history + 1)),
                                 len(clicked_pool))
                    if hist_n > 0:
                        pick = rng.integers(0, len(clicked_pool), size=hist_n)
                        hist_ids = np.asarray(
                            [clicked_pool[j] for j in pick], np.int64)
                        logit += float(np.mean(hidden_w[hist_ids])) \
                            * float(np.mean(hidden_w[ids])) * 2.0
                label = float(rng.random() < 1.0 / (1.0 + np.exp(-logit)))
                if history > 0 and label > 0:
                    clicked_pool.extend(int(i) for i in ids)
                    if len(clicked_pool) > 4096:
                        del clicked_pool[:-4096]
                label2 = None
                if num_labels == 2:
                    label2 = 0.0
                    if label > 0:
                        logit2 = float(np.dot(hidden_w2[ids], vals)) * 0.5
                        label2 = float(
                            rng.random() < 1.0 / (1.0 + np.exp(-logit2)))
                w.write(example_codec.encode_ctr_example(
                    label, ids, vals, label2=label2, hist_ids=hist_ids))
    return paths
