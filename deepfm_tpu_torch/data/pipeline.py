"""Host-side input pipeline: TFRecord -> fixed-shape numpy batches.

The port's copy of the per-record path of ``deepfm_tpu.data.pipeline``'s
``CtrPipeline``: per-epoch seeded file-order shuffle, a buffered uniform
record shuffle (``tf.data.Dataset.shuffle`` semantics, seeded
``seed * 1_000_003 + epoch``), pure-Python decode, ``drop_remainder``,
``skip_batches`` for step-accurate resume and a prefetch thread. For the
same files and seed its batches are bit-identical to the JAX package's
``CtrPipeline(..., use_native_decoder=False)``.

The JAX package's native C++ decoder, its pooled vectorized path, the
decoded-epoch cache and the multi-process input service are not ported: a
pipeline built with ``use_native_decoder=True`` logs that once and takes the
per-record path.

Batches are ``{"feat_ids": int32[B,F], "feat_vals": f32[B,F],
"label": f32[B,1]}``.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from . import example_codec, tfrecord

log = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]

_native_notice = threading.Event()


def decode_batch_python(records: Sequence[bytes], field_size: int):
    """Decode records with the Python codec -> (labels [n], ids [n,F] int32,
    vals [n,F] float32)."""
    n = len(records)
    labels = np.empty((n,), np.float32)
    ids = np.empty((n, field_size), np.int32)
    vals = np.empty((n, field_size), np.float32)
    for i, rec in enumerate(records):
        lab, rid, rval = example_codec.decode_ctr_example(rec, field_size)
        labels[i] = lab
        ids[i] = rid.astype(np.int32)
        vals[i] = rval
    return labels, ids, vals


class CtrPipeline:
    """TFRecord CTR input pipeline producing fixed-shape numpy batches."""

    def __init__(self, files: Sequence[str], *, field_size: int,
                 batch_size: int, num_epochs: int = 1, shuffle: bool = True,
                 shuffle_files: bool = True, shuffle_buffer: int = 10000,
                 drop_remainder: bool = True, seed: int = 42,
                 prefetch_batches: int = 4, use_native_decoder: bool = False,
                 verify_crc: bool = False, epoch_offset: int = 0,
                 skip_batches: int = 0):
        if use_native_decoder and not _native_notice.is_set():
            _native_notice.set()
            log.info("use_native_decoder: the native TFRecord decoder is not "
                     "ported to deepfm_tpu_torch yet; decoding per record in "
                     "Python")
        self._files = tuple(files)
        self.field_size = field_size
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.shuffle = shuffle
        self.shuffle_files = shuffle_files
        self.shuffle_buffer = shuffle_buffer
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.verify_crc = verify_crc
        # Shifts the epoch index that seeds both shuffles: the train task
        # builds one single-epoch pipeline per epoch.
        self.epoch_offset = epoch_offset
        # Step-accurate resume: the first N batches (already trained) are
        # decoded past, not emitted.
        self.skip_batches = skip_batches

    def _epoch_files(self, epoch: int) -> List[str]:
        """The per-epoch file order: a seeded reshuffle per epoch."""
        files = list(self._files)
        if self.shuffle_files:
            np.random.default_rng(self.seed + epoch).shuffle(files)
        return files

    def _iter_raw_records(self, epoch: int) -> Iterator[bytes]:
        files = self._epoch_files(epoch)
        n_seen = 0
        for path in files:
            for rec in tfrecord.iter_records(path,
                                             verify_crc=self.verify_crc):
                n_seen += 1
                yield rec
        if n_seen == 0 and files:
            raise IOError(f"no records found in {len(files)} files")

    def _iter_shuffled(self, epoch: int) -> Iterator[bytes]:
        """Buffered uniform shuffle (tf.data.Dataset.shuffle semantics)."""
        if not self.shuffle or self.shuffle_buffer <= 1:
            yield from self._iter_raw_records(epoch)
            return
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        buf: List[bytes] = []
        for rec in self._iter_raw_records(epoch):
            if len(buf) < self.shuffle_buffer:
                buf.append(rec)
                continue
            j = int(rng.integers(0, len(buf)))
            yield buf[j]
            buf[j] = rec
        rng.shuffle(buf)
        yield from buf

    def _make_batch(self, records: List[bytes]) -> Batch:
        labels, ids, vals = decode_batch_python(records, self.field_size)
        return {
            "feat_ids": np.ascontiguousarray(ids, np.int32),
            "feat_vals": np.ascontiguousarray(vals, np.float32),
            "label": labels.reshape(-1, 1).astype(np.float32),
        }

    def _iter_batches(self) -> Iterator[Batch]:
        skip = self.skip_batches
        for e in range(self.num_epochs):
            epoch = e + self.epoch_offset
            pending: List[bytes] = []
            for rec in self._iter_shuffled(epoch):
                pending.append(rec)
                if len(pending) == self.batch_size:
                    if skip:
                        skip -= 1
                    else:
                        yield self._make_batch(pending)
                    pending = []
            if pending and not self.drop_remainder:
                if skip:
                    skip -= 1
                else:
                    yield self._make_batch(pending)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch_batches <= 0:
            yield from self._iter_batches()
            return
        yield from prefetch(self._iter_batches(), self.prefetch_batches)

    def count_examples(self) -> int:
        """One full pass counting records."""
        return sum(1 for _ in self._iter_raw_records(epoch=0))


def prefetch(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a daemon thread, keeping up to ``depth`` items ready.

    If the consumer stops early, closing this generator sets a stop flag;
    the producer's bounded put polls it, drops out and closes the source,
    so no thread stays blocked and no file handle leaks. An exception in
    the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # propagate into consumer
            put(e)
        finally:
            if stop.is_set():
                close = getattr(it, "close", None)
                if close is not None:
                    close()

    t = threading.Thread(target=worker, daemon=True, name="pipeline-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                item.add_note(f"raised in pipeline prefetch thread {t.name!r}")
                raise item from None
            yield item
    finally:
        stop.set()
