"""Host-side input pipeline: TFRecord -> fixed-shape numpy batches.

The port's copy of ``deepfm_tpu.data.pipeline``'s ``CtrPipeline`` (one
process). For the same files, seed and flags its batches are bit-identical
to the JAX package's. Two emission paths:

* Pooled (``use_native_decoder=True``, the default): ~64 MB read chunks
  framed by the native decoder (``native.loader``), pooled until
  ``max(shuffle_buffer, k * batch_size)`` records, one seeded permutation
  per drain (``default_rng(seed * 1_000_003 + epoch)``), and the permuted
  pool sliced into batches. With shuffle on, the proto decode is deferred
  to the drain and each record decodes straight into its permuted row,
  either in one C call per drain (``native_assembly``) or per chunk span
  on the reader threads; both write the same bytes. ``iter_superbatches(k)``
  emits k batches at a time as one contiguous block (the zero-copy feed of
  the fit loop's k-step dispatch).
* Per record (``use_native_decoder=False``): a buffered uniform record
  shuffle (``tf.data.Dataset.shuffle`` semantics) and the Python codec.

The native decoder is built at first use or the pipeline raises: no path
switches to per-record decode unasked. Corrupt or truncated frames go
through ``health.BadRecordPolicy`` (raise naming the path and byte offset,
or a counted skip), transient read errors heal through
``fileio.ResilientStream``, and ``decoded_cache`` (``ram`` | ``disk``)
serves later epochs from decoded columns (``data.cache``), which the
device-resident fit uploads once. ``skip_batches`` (step-accurate resume)
is applied inside each emission path. ``input_workers`` moves the pooled
path's frame+decode into spawned worker processes (``data.workers``) with
the same emission; a service that cannot start raises.

Pipe mode: :class:`StreamingCtrPipeline` decodes batches in stream order
from one sequential byte source, a :class:`ChainedFileStream` (the files
replayed once per epoch by the producer) or the online trainer's
``data.stream.UnboundedFileStream``.

Batches are ``{"feat_ids": int32[B,F], "feat_vals": f32[B,F],
"label": f32[B,1]}``. With ``num_labels=2`` (multi-task training, ``--tasks
ctr,cvr``) they gain ``"label2"`` f32[B,1] from the optional on-disk key;
with ``history=True`` (sequence models) ``"hist_ids"`` int32[B,L] and
``"hist_mask"`` f32[B,L], the ragged on-disk pair padded or truncated to
``history_max_len``. Either extension takes the eager decode path only, as
in the JAX package: the fused assembly, the input service and the decoded
cache are single-label layouts, so they are forced off. The pool carries
the history as packed columns (ids ``feat_ids || hist_ids``, vals
``feat_vals || hist_mask``), split at batch assembly.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
import time
import weakref
from typing import BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import example_codec, fileio, tfrecord
from .health import BadRecordPolicy, DataHealth

Batch = Dict[str, np.ndarray]

# Read size of the native framer: big enough to amortize a call, small
# enough to keep memory constant on large files.
_NATIVE_CHUNK_BYTES = 64 << 20

# Least records per sub-span when a drain splits one big chunk across
# reader threads. Module-level so tests can lower it.
_SCATTER_SPLIT_MIN = 4096

# Read size past a file's stat()ed length (a file may grow after the stat):
# a bounded probe, not a full chunk.
_EOF_PROBE_BYTES = 64 << 10


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


def decode_batch2_python(records: Sequence[bytes], field_size: int):
    """Two-label :func:`decode_batch_python`: (labels, labels2, ids, vals),
    ``label2`` 0.0 where a record has none (``loader.decode_batch2``'s
    Python mirror)."""
    n = len(records)
    labels = np.empty((n,), np.float32)
    labels2 = np.empty((n,), np.float32)
    ids = np.empty((n, field_size), np.int32)
    vals = np.empty((n, field_size), np.float32)
    for i, rec in enumerate(records):
        lab, lab2, rid, rval = example_codec.decode_ctr_example2(
            rec, field_size)
        labels[i] = lab
        labels2[i] = lab2
        ids[i] = rid.astype(np.int32)
        vals[i] = rval
    return labels, labels2, ids, vals


def decode_batch_hist_python(records: Sequence[bytes], field_size: int,
                             max_len: int):
    """History :func:`decode_batch_python`: (labels, ids, vals, hist_ids
    [n, max_len] int32, hist_vals [n, max_len] float32, hist_len [n] int32)
    (``loader.decode_batch_hist``'s Python mirror)."""
    n = len(records)
    labels = np.empty((n,), np.float32)
    ids = np.empty((n, field_size), np.int32)
    vals = np.empty((n, field_size), np.float32)
    hist_ids = np.zeros((n, max_len), np.int32)
    hist_vals = np.zeros((n, max_len), np.float32)
    hist_len = np.zeros((n,), np.int32)
    for i, rec in enumerate(records):
        lab, rid, rval, hid, hval, hn = example_codec.decode_ctr_example_hist(
            rec, field_size, max_len)
        labels[i] = lab
        ids[i] = rid.astype(np.int32)
        vals[i] = rval
        hist_ids[i] = hid
        hist_vals[i] = hval
        hist_len[i] = hn
    return labels, ids, vals, hist_ids, hist_vals, hist_len


def _timed(stats, name: str):
    """Stage timer of ``stats`` (a ``profiling.HostStageStats``), or a no-op
    when none is attached."""
    if stats is None:
        return contextlib.nullcontext()
    return stats.stage(name)


def _native_loader():
    """The native decoder module, its library built and loaded (raises
    ``KernelBuildError`` with the compiler's output when it cannot be)."""
    from ..native import loader  # noqa: PLC0415 (builds at first use)
    loader.load()
    return loader


def _iter_framed_stream(stream: BinaryIO, loader, verify_crc: bool = True,
                        *, path: str = "",
                        policy: Optional[BadRecordPolicy] = None,
                        size_hint: Optional[int] = None, stats=None
                        ) -> Iterator[Tuple[bytes, np.ndarray, np.ndarray]]:
    """Chunked read() + native framing with a carried partial tail: yields
    ``(buf, offsets, lengths)`` per chunk of any sequential byte source.

    A chunk the native framer rejects is framed again by the Python framer,
    which finds the bad frame's absolute byte offset (for the error) and
    applies ``policy``; clean data never takes that path. ``size_hint``
    (the file's stat()ed length) caps each read at the bytes left; past it
    reads continue in ``_EOF_PROBE_BYTES`` requests, so the spans are the
    same with or without the hint."""
    carry = b""
    carry_base = 0  # absolute stream offset of carry[0]
    read_size = _NATIVE_CHUNK_BYTES
    pos = 0  # bytes read from the stream so far
    while True:
        if size_hint is not None and size_hint > pos:
            want = min(read_size, size_hint - pos)
        elif size_hint is not None:
            want = _EOF_PROBE_BYTES
        else:
            want = read_size
        with _timed(stats, "read"):
            chunk = stream.read(want)
        if not chunk:
            if carry:
                # Strict parse of the leftover: a truncated tail raises (or
                # is a counted skip under the policy).
                with _timed(stats, "frame"):
                    try:
                        offsets, lengths = loader.split_frames(
                            carry, verify_crc=verify_crc)
                    except IOError:
                        offsets, lengths, _, _ = tfrecord.scan_frames_partial(
                            carry, verify_crc=verify_crc, final=True,
                            base_offset=carry_base, path=path, policy=policy)
                yield carry, offsets, lengths
            return
        pos += len(chunk)
        buf = carry + chunk if carry else chunk
        buf_base = carry_base
        abort = False
        with _timed(stats, "frame"):
            try:
                offsets, lengths, consumed = loader.split_frames_partial(
                    buf, verify_crc=verify_crc)
            except IOError:
                offsets, lengths, consumed, abort = \
                    tfrecord.scan_frames_partial(
                        buf, verify_crc=verify_crc, final=False,
                        base_offset=buf_base, path=path, policy=policy)
        yield buf, offsets, lengths
        if abort:  # framing cannot resync past the corruption
            return
        carry = buf[consumed:]
        carry_base = buf_base + consumed
        # A record larger than the read frames nothing (consumed=0): double
        # the next read, so the carry is not re-copied O(n^2) times.
        read_size = (_NATIVE_CHUNK_BYTES if consumed
                     else max(read_size * 2, _NATIVE_CHUNK_BYTES))


def _health_retry_cb(policy: Optional[BadRecordPolicy], path: str):
    """on_retry hook that records healed transient reads in DataHealth."""
    if policy is None:
        return None
    health = policy.health
    return lambda exc, n: health.record_retry(path)


def _iter_framed_chunks(path: str, loader, verify_crc: bool = True, *,
                        policy: Optional[BadRecordPolicy] = None,
                        retry_policy=None, stats=None
                        ) -> Iterator[Tuple[bytes, np.ndarray, np.ndarray]]:
    """``_iter_framed_stream`` over a file, read through a ResilientStream
    so transient mid-file errors heal; the stat()ed length is the size
    hint (a failed stat means unhinted reads, not an error)."""
    try:
        size_hint: Optional[int] = fileio.size(path)
    except OSError:
        size_hint = None
    with fileio.open_resilient(path, policy=retry_policy,
                               on_retry=_health_retry_cb(policy, path)) as f:
        yield from _iter_framed_stream(f, loader, verify_crc, path=path,
                                       policy=policy, size_hint=size_hint,
                                       stats=stats)


def _iter_file_records(path: str, use_native: bool, verify_crc: bool = True,
                       *, policy: Optional[BadRecordPolicy] = None,
                       retry_policy=None) -> Iterator[bytes]:
    """Per-file record iterator with the same CRC and bad-record policy on
    both framers."""
    if use_native:
        loader = _native_loader()
        for buf, offsets, lengths in _iter_framed_chunks(
                path, loader, verify_crc, policy=policy,
                retry_policy=retry_policy):
            for off, ln in zip(offsets.tolist(), lengths.tolist()):
                yield buf[off:off + ln]
        return
    yield from tfrecord.iter_records(
        path, verify_crc=verify_crc, policy=policy, resilient=True,
        retry_policy=retry_policy, on_retry=_health_retry_cb(policy, path))


def _available_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))  # cgroup and affinity limits
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def _trim_skip(src: Iterator[Tuple[Batch, int, int]], skip: int, bs: int
               ) -> Iterator[Tuple[Batch, int, int]]:
    """Drop the first ``skip`` batches of a grouped ``(rows, m, n_ex)``
    stream: whole emissions dropped, a partly covered group sliced (the
    rows left stay one contiguous block)."""
    for rows, m, n_ex in src:
        if skip:
            if m <= skip:
                skip -= m
                continue
            rows = {key: v[skip * bs:] for key, v in rows.items()}
            m -= skip
            n_ex -= skip * bs
            skip = 0
        yield rows, m, n_ex


def _group_plain_batches(batches: Iterator[Batch], k: int, bs: int
                         ) -> Iterator[Tuple[Batch, int, int]]:
    """Superbatch grouping over a per-batch stream (a concatenate copy):
    full groups of k, a short tail flushed as singles."""
    group: List[Batch] = []
    for b in batches:
        if b["label"].shape[0] == bs:
            group.append(b)
            if len(group) == k:
                yield ({key: np.concatenate([g[key] for g in group])
                        for key in group[0]}, k, k * bs)
                group = []
        else:  # short tail: flush the pending batches, then emit it
            for g in group:
                yield g, 1, bs
            group = []
            yield b, 1, b["label"].shape[0]
    for g in group:
        yield g, 1, bs


class _DrainPool:
    """Lazily created drain-decode thread pool owned by ONE iterator: it
    persists across that iterator's drains, and a second live iterator of
    the same pipeline has its own, so one ending cannot stop the other's
    drain."""

    def __init__(self, n_threads: int):
        self._n = n_threads
        self._ex = None

    def get(self):
        if self._ex is None:
            from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415
            self._ex = ThreadPoolExecutor(self._n)
        return self._ex

    def shutdown(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=False)
            self._ex = None


class CtrPipeline:
    """TFRecord CTR input pipeline producing fixed-shape numpy batches."""

    def __init__(self, files: Sequence[str], *, field_size: int,
                 batch_size: int, num_epochs: int = 1, shuffle: bool = True,
                 shuffle_files: bool = True, shuffle_buffer: int = 10000,
                 drop_remainder: bool = True, seed: int = 42,
                 prefetch_batches: int = 4, use_native_decoder: bool = True,
                 native_assembly: bool = True, reader_threads: int = 4,
                 verify_crc: bool = False, epoch_offset: int = 0,
                 skip_batches: int = 0, on_bad_record: str = "raise",
                 max_bad_records: int = 0, retry_policy=None,
                 decoded_cache: str = "off", decoded_cache_dir: str = "",
                 input_workers: int = 0,
                 input_worker_slab_records: Optional[int] = None,
                 input_worker_death: str = "raise",
                 stall_timeout_s: float = 0.0, num_labels: int = 1,
                 history: bool = False, history_max_len: int = 20):
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
        # Reader threads help only where the GIL-released decoder can run
        # on another core: clamp to the cores this process may use.
        self.reader_threads = max(1, min(reader_threads, _available_cores()))
        self._use_native = bool(use_native_decoder)
        # Fused decode->assemble (one C call per drain) or per-chunk
        # scatter: the same bytes either way.
        self.native_assembly = bool(native_assembly)
        self.verify_crc = verify_crc
        # Optional per-stage timer (profiling.HostStageStats).
        self.stage_stats = None
        # Shifts the epoch index that seeds both shuffles: the train task
        # builds one single-epoch pipeline per epoch.
        self.epoch_offset = epoch_offset
        # Step-accurate resume: the first N batches (already trained) are
        # dropped inside each emission path, from the stream that trained.
        self.skip_batches = skip_batches
        # One DataHealth/BadRecordPolicy pair per pipeline (the skip budget
        # spans its epochs); the retry policy governs opens and mid-file
        # reopen-and-seek healing.
        self.health = DataHealth()
        self._bad_policy = BadRecordPolicy(on_bad_record, max_bad_records,
                                           self.health)
        self._retry_policy = retry_policy
        self._on_bad_record = on_bad_record
        self._max_bad_records = max_bad_records
        self.decoded_cache = decoded_cache
        self.decoded_cache_dir = decoded_cache_dir
        self._cache_cols = None  # built or loaded lazily, reused by epochs
        # The multi-process input service (data.workers): decode worker
        # processes fill shared-memory slabs that the pool reads without a
        # copy. It serves the pooled native path; cached columns need no
        # decode and the per-record path has no chunks, so either keeps the
        # in-process decode (a choice of configuration, not a fallback).
        self.input_workers = max(0, int(input_workers))
        self.input_worker_slab_records = input_worker_slab_records
        self.input_worker_death = input_worker_death
        # A worker's one-shot crash after N messages (a drill's seam).
        self.input_worker_fault_die_after: Optional[int] = None
        # Ring reads raise InputStallError after this long without a
        # message from a live worker (0: wait forever).
        self.stall_timeout_s = float(stall_timeout_s)
        # Multi-label and history emission take the eager decode path only:
        # the fused assembly, the worker slabs and the decoded cache are
        # single-label layouts, forced off rather than dropping a column.
        self.num_labels = max(1, int(num_labels))
        if self.num_labels > 2:
            raise ValueError(
                f"num_labels must be 1 or 2, got {num_labels} (the on-disk "
                "schema carries at most one extra 'label2' column)")
        self.history = bool(history)
        self.history_max_len = int(history_max_len)
        if self.history and self.num_labels > 1:
            raise ValueError(
                "history=True is incompatible with num_labels>1 (one "
                "optional schema extension per stream)")
        if self.history and self.history_max_len < 1:
            raise ValueError(
                f"history_max_len must be >= 1 when history=True, got "
                f"{history_max_len}")
        if self.num_labels > 1 or self.history:
            self.input_workers = 0
            self.native_assembly = False
            self.decoded_cache = "off"
        # Pool column width: the history rides the (labels, ids, vals)
        # chunks as packed columns, split at batch assembly.
        self._pool_cols = self.field_size + (
            self.history_max_len if self.history else 0)
        if self._use_native:
            _native_loader()  # build now: a failed build raises here

    # ------------------------------------------------------------------
    # Pooled path
    # ------------------------------------------------------------------
    def _iter_decoded_chunks(self, epoch: int, loader
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]]:
        """Per chunk: frame, then decode eagerly -> (labels, ids, vals), on
        the reader threads (bounded in-flight depth, FIFO order)."""
        def decode(job: Tuple[bytes, np.ndarray, np.ndarray]):
            buf, offsets, lengths = job
            if self.num_labels > 1:
                labels, labels2, ids, vals = loader.decode_spans2(
                    buf, offsets, lengths, self.field_size)
                return np.stack([labels, labels2], axis=1), ids, vals
            if self.history:
                labels, ids, vals, hid, hmask, _ = loader.decode_spans_hist(
                    buf, offsets, lengths, self.field_size,
                    self.history_max_len)
                return (labels, np.hstack([ids, hid]),
                        np.hstack([vals, hmask]))
            return loader.decode_spans(buf, offsets, lengths,
                                       self.field_size)

        jobs = self._iter_framed_span_chunks(epoch, loader)
        n_threads = self.reader_threads
        if n_threads <= 1:
            for job in jobs:
                yield decode(job)
            return
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415
        with ThreadPoolExecutor(n_threads) as ex:
            inflight: "collections.deque" = collections.deque()
            for job in jobs:
                inflight.append(ex.submit(decode, job))
                while len(inflight) >= n_threads + 1:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()

    def _epoch_files(self, epoch: int) -> List[str]:
        """The per-epoch file order: a seeded reshuffle per epoch."""
        files = list(self._files)
        if self.shuffle_files:
            np.random.default_rng(self.seed + epoch).shuffle(files)
        return files

    def _epoch_file_order(self, epoch: int) -> List[int]:
        """Canonical file indices in ``_epoch_files`` order (shuffling a
        list of positions consumes the rng as shuffling the paths does)."""
        order = list(range(len(self._files)))
        if self.shuffle_files:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    # -- decoded-epoch cache ---------------------------------------------
    def _make_cache(self):
        from . import cache as cache_lib  # noqa: PLC0415
        return cache_lib.DecodedEpochCache(
            self.decoded_cache, self.decoded_cache_dir, list(self._files),
            field_size=self.field_size, verify_crc=self.verify_crc,
            on_bad_record=self._on_bad_record,
            max_bad_records=self._max_bad_records,
            use_native=self._use_native, health=self.health)

    def _build_cache_columns(self):
        """One frame+decode pass in canonical file order -> contiguous
        columns and per-file counts, through the streaming paths' framing,
        CRC and bad-record machinery: the cache holds exactly the rows a
        streamed epoch trains on."""
        from . import cache as cache_lib  # noqa: PLC0415
        loader = _native_loader() if self._use_native else None
        counts = np.zeros(len(self._files), np.int64)
        labs: List[np.ndarray] = []
        idss: List[np.ndarray] = []
        valss: List[np.ndarray] = []
        for fi, path in enumerate(self._files):
            n_file = 0
            if loader is not None:
                for buf, offsets, lengths in _iter_framed_chunks(
                        path, loader, self.verify_crc,
                        policy=self._bad_policy,
                        retry_policy=self._retry_policy,
                        stats=self.stage_stats):
                    if len(offsets) == 0:
                        continue
                    with _timed(self.stage_stats, "decode_assemble"):
                        lab, ids, vals = loader.decode_spans(
                            buf, offsets, lengths, self.field_size)
                    labs.append(lab)
                    idss.append(ids)
                    valss.append(vals)
                    n_file += len(lab)
            else:
                recs = list(_iter_file_records(
                    path, False, self.verify_crc, policy=self._bad_policy,
                    retry_policy=self._retry_policy))
                if recs:
                    lab, ids, vals = decode_batch_python(recs,
                                                         self.field_size)
                    labs.append(lab)
                    idss.append(ids)
                    valss.append(vals)
                    n_file += len(lab)
            counts[fi] = n_file
        if counts.sum() == 0 and len(self._files):
            raise IOError(f"no records found in {len(self._files)} files")
        return cache_lib.CacheColumns(
            np.concatenate(labs).astype(np.float32, copy=False),
            np.concatenate(idss), np.concatenate(valss), counts)

    def decoded_epoch_columns(self):
        """The dataset as cached columns, built on a miss (also what the
        device-resident fit uploads). Raises when the cache is off."""
        if self.decoded_cache == "off":
            raise RuntimeError("decoded_epoch_columns requires decoded_cache")
        if self._cache_cols is None:
            self._cache_cols = self._make_cache().get_or_build(
                self._build_cache_columns)
        return self._cache_cols

    def decoded_cache_fingerprint(self) -> str:
        """Identity of the cached columns (the device upload's key)."""
        return self._make_cache().fingerprint

    def device_epoch_indices(self, epoch: int, k: int = 1) -> np.ndarray:
        """Row indices into the cached columns in exactly the order the
        pooled path emits them this epoch (the device-resident fit's
        per-epoch index, 4 bytes a record).

        Valid only when the pool covers the epoch
        (``n < max(shuffle_buffer, k * batch_size)``): the one drain then
        sends arrival row j to position perm[j] of one permutation, so the
        emission is ``arrival[argsort(perm)]``. With a smaller pool the
        drain points depend on chunk arrival."""
        cols = self.decoded_epoch_columns()
        starts = np.zeros(len(cols.counts) + 1, np.int64)
        np.cumsum(cols.counts, out=starts[1:])
        arrival = np.concatenate([
            np.arange(starts[fi], starts[fi + 1], dtype=np.int64)
            for fi in self._epoch_file_order(epoch)]) if len(cols.counts) \
            else np.zeros((0,), np.int64)
        if not self.shuffle:
            return arrival.astype(np.int32)
        n = len(arrival)
        if n >= max(self.shuffle_buffer, k * self.batch_size):
            raise ValueError(
                "device_epoch_indices requires the shuffle pool to cover "
                f"the epoch (n={n} >= pool target); use the staged path")
        perm = np.random.default_rng(
            self.seed * 1_000_003 + epoch).permutation(n)
        return arrival[np.argsort(perm)].astype(np.int32)

    def _make_input_service(self, epoch: int):
        """Start the decode-worker fleet for one epoch. A service that
        cannot start (no spawn, no POSIX shared memory) raises, naming
        ``--input_workers``: the run never switches to in-process decode
        unasked."""
        from . import workers  # noqa: PLC0415 (spawns processes)
        try:
            return workers.ShmInputService(
                self._epoch_files(epoch), field_size=self.field_size,
                num_workers=self.input_workers,
                slab_records=self.input_worker_slab_records,
                verify_crc=self.verify_crc,
                on_bad_record=self._bad_policy.on_bad,
                max_bad_records=self._bad_policy.max_bad,
                retry_policy=self._retry_policy, health=self.health,
                on_worker_death=self.input_worker_death,
                fault_die_after=self.input_worker_fault_die_after,
                stall_timeout_s=self.stall_timeout_s).start()
        except Exception as exc:
            raise RuntimeError(
                f"--input_workers {self.input_workers}: the input service "
                f"could not start ({exc!r}); set --input_workers 0 to decode "
                "in process") from exc

    def _iter_framed_span_chunks(self, epoch: int, loader
                                 ) -> Iterator[Tuple[bytes, np.ndarray,
                                                     np.ndarray]]:
        """Framed (and CRC-checked) chunks, not decoded: the one source of
        file order and framing for both pooled decodes, so the fused and
        the eager emissions cannot drift apart."""
        files = self._epoch_files(epoch)
        got_any = False
        for path in files:
            for buf, offsets, lengths in _iter_framed_chunks(
                    path, loader, self.verify_crc, policy=self._bad_policy,
                    retry_policy=self._retry_policy, stats=self.stage_stats):
                if len(offsets) == 0:
                    continue
                got_any = True
                yield buf, offsets, lengths
        if not got_any and files:
            raise IOError(f"no records found in {len(files)} files")

    def _scatter_decode_raw(self, loader, raw, perm: np.ndarray, off: int,
                            labels: np.ndarray, ids: np.ndarray,
                            vals: np.ndarray, pool: "_DrainPool") -> None:
        """Decode every raw span chunk straight into its permuted pool rows.
        Rows are disjoint across chunks and the C calls release the GIL, so
        chunks decode on the reader threads; a big chunk is split into
        contiguous sub-spans (>= _SCATTER_SPLIT_MIN records each). With
        ``native_assembly`` one thread crosses ctypes once per drain
        (``assemble_spans`` over every chunk) instead of once per chunk.
        Every route writes the same pool bytes."""
        jobs = []
        for buf, offsets, lengths in raw:
            m = len(offsets)
            parts = max(1, min(self.reader_threads, m // _SCATTER_SPLIT_MIN))
            step = (m + parts - 1) // parts
            for s in range(0, m, step):
                e = min(s + step, m)
                jobs.append((buf, offsets[s:e], lengths[s:e],
                             perm[off + s:off + e]))
            off += m
        if self.native_assembly:
            if len(jobs) <= 1 or self.reader_threads <= 1:
                loader.assemble_spans(jobs, self.field_size, labels, ids,
                                      vals)
            else:
                list(pool.get().map(
                    lambda job: loader.assemble_spans(
                        [job], self.field_size, labels, ids, vals), jobs))
            return
        lab_flat = labels.reshape(-1)

        def run(job):
            buf, offs, lens, dest = job
            loader.decode_spans_scatter(buf, offs, lens, self.field_size,
                                        dest, lab_flat, ids, vals)

        if len(jobs) <= 1 or self.reader_threads <= 1:
            for job in jobs:
                run(job)
        else:
            list(pool.get().map(run, jobs))

    def _iter_pooled(self, loader, k: int
                     ) -> Iterator[Tuple[Batch, int, int]]:
        """``_iter_pooled_raw`` with the resume skip trimmed from THIS
        stream."""
        yield from _trim_skip(self._iter_pooled_raw(loader, k),
                              self.skip_batches, self.batch_size)

    def _iter_pooled_raw(self, loader, k: int
                         ) -> Iterator[Tuple[Batch, int, int]]:
        """The pool/permute/drain machinery of both the per-batch and the
        k-step feeds: yields ``(rows, m, n_examples)``, ``rows`` being ``m``
        batches as contiguous ``[m * batch_size, ...]`` arrays (``m <= k``;
        the end of each epoch emits single batches, the last possibly
        short). A non-final drain emits only full k-groups, so a group is
        always one contiguous pool slice."""
        bs = self.batch_size
        sb = bs * max(k, 1)
        # Cached columns replace every decode: chunks are zero-copy views
        # into the slabs.
        cached_cols = None
        if self.decoded_cache != "off":
            from . import cache as cache_lib  # noqa: PLC0415
            cached_cols = self.decoded_epoch_columns()
        # Fused scatter-decode: with shuffle on, each record decodes at the
        # drain straight into its permuted row (one pass, not decode then
        # scatter). The permutation, arrival order and rng stream are the
        # eager path's, so the emission is the same.
        use_shm = (cached_cols is None and self.input_workers > 0
                   and loader is not None)
        fused = (not use_shm and self.shuffle and loader is not None
                 and self.num_labels == 1 and not self.history)
        drain_pool = _DrainPool(self.reader_threads)
        stats = self.stage_stats
        try:
            for e in range(self.num_epochs):
                epoch = e + self.epoch_offset
                rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
                pool_target = (max(self.shuffle_buffer, sb)
                               if self.shuffle else sb)
                pend: "collections.deque" = collections.deque()
                raw: List[Tuple[bytes, np.ndarray, np.ndarray]] = []
                n_pend = 0
                service = self._make_input_service(epoch) if use_shm else None

                def drain(final: bool, service=service
                          ) -> Iterator[Tuple[Batch, int, int]]:
                    nonlocal pend, raw, n_pend
                    if self.shuffle and n_pend > 0 and (pend or raw):
                        # Row j of the arrival order lands at perm[j] of one
                        # preallocated pool: the decoded remainder (pend)
                        # first, then the raw chunks decode into theirs.
                        with _timed(stats, "decode_assemble"):
                            perm = rng.permutation(n_pend)
                            # The label column is [n, 1]: a batch slice IS
                            # the emitted ``label`` array.
                            labels = np.empty((n_pend, self.num_labels),
                                              np.float32)
                            lab_col = labels.reshape(-1)
                            ids = np.empty((n_pend, self._pool_cols),
                                           np.int32)
                            vals = np.empty((n_pend, self._pool_cols),
                                            np.float32)
                            off = 0
                            for lab, idx, val in pend:
                                dest = perm[off:off + len(lab)]
                                if self.num_labels == 1:
                                    lab_col[dest] = lab.reshape(-1)
                                else:
                                    labels[dest] = lab.reshape(len(lab), -1)
                                ids[dest] = idx
                                vals[dest] = val
                                off += len(lab)
                            if raw:
                                self._scatter_decode_raw(
                                    loader, raw, perm, off, labels, ids,
                                    vals, drain_pool)
                        pend = collections.deque([(labels, ids, vals)])
                        raw = []
                        if service is not None:
                            # Every held slab view is scattered into the
                            # fresh pool: hand the slots back to the workers.
                            service.release_consumed()
                    hl = self.history_max_len if self.history else 0
                    while n_pend >= sb:
                        with _timed(stats, "emit"):
                            rows = self._assemble_batch(pend, sb, hl)
                        yield rows, k, sb
                        n_pend -= sb
                    if final:
                        while n_pend >= bs:
                            with _timed(stats, "emit"):
                                rows = self._assemble_batch(pend, bs, hl)
                            yield rows, 1, bs
                            n_pend -= bs
                        if n_pend and not self.drop_remainder:
                            with _timed(stats, "emit"):
                                rows = self._assemble_batch(pend, n_pend,
                                                            hl)
                            yield rows, 1, n_pend
                            n_pend = 0

                if cached_cols is not None:
                    for chunk in cache_lib.epoch_chunks(
                            cached_cols, self._epoch_file_order(epoch)):
                        pend.append(chunk)
                        n_pend += len(chunk[0])
                        if n_pend >= pool_target:
                            yield from drain(final=False)
                elif service is not None:
                    with service:
                        # Without shuffle nothing scatters, so batch slices
                        # would keep slab views alive: copy out instead.
                        for chunk in service.chunks(copy=not self.shuffle):
                            pend.append(chunk)
                            n_pend += len(chunk[0])
                            if n_pend >= pool_target:
                                yield from drain(final=False)
                        yield from drain(final=True)
                    continue
                elif fused:
                    for span in self._iter_framed_span_chunks(epoch, loader):
                        raw.append(span)
                        n_pend += len(span[1])
                        if n_pend >= pool_target:
                            yield from drain(final=False)
                else:
                    for chunk in self._iter_decoded_chunks(epoch, loader):
                        pend.append(chunk)
                        n_pend += len(chunk[0])
                        if n_pend >= pool_target:
                            yield from drain(final=False)
                yield from drain(final=True)
        finally:
            # Release the drain executor when the generator ends or is
            # abandoned (GeneratorExit lands here).
            drain_pool.shutdown()

    def iter_superbatches(self, k: int) -> Iterator[Tuple[Batch, int, int]]:
        """Yield ``(rows, m, n_examples)``: ``rows`` holds ``m`` batches as
        contiguous ``[m * batch_size, ...]`` arrays (``m <= k``; the end of
        an epoch may emit single short batches with ``m == 1``).

        The zero-copy feed of the k-step dispatch: the permuted pool is one
        contiguous array, so a k-group is a slice of it, where stacking k
        single batches would copy every row again on the decoding core."""
        pooled = self._use_native or self.decoded_cache != "off"
        if not pooled or k <= 1:
            # Per-record path: group plain batches (skip and prefetch are
            # handled by __iter__).
            yield from _group_plain_batches(iter(self), k, self.batch_size)
            return
        loader = _native_loader() if self._use_native else None
        # The pooled path bypasses __iter__'s prefetch: decode ahead here,
        # in k-groups, so decode overlaps the consumer's transfer.
        src = self._iter_pooled(loader, k)
        if self.prefetch_batches > 0:
            src = prefetch(src, max(1, self.prefetch_batches // k))
        yield from src

    @staticmethod
    def _assemble_batch(pend: "collections.deque", bs: int,
                        hist_len: int = 0) -> Batch:
        """Pop exactly ``bs`` rows off the front of the pending chunk deque
        (O(1) per chunk). A contiguous pool slice passes through as a view:
        same bytes, no copy. With ``hist_len > 0`` the trailing
        ``hist_len`` packed columns split out into ``hist_ids`` and
        ``hist_mask``; [n, 2] label chunks split into ``label`` and
        ``label2``."""
        take: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        need = bs
        while need:
            labels, ids, vals = pend[0]
            if len(labels) <= need:
                take.append(pend.popleft())
                need -= len(labels)
            else:
                take.append((labels[:need], ids[:need], vals[:need]))
                pend[0] = (labels[need:], ids[need:], vals[need:])
                need = 0
        if len(take) == 1:
            labels, ids, vals = take[0]
        else:
            labels = np.concatenate([t[0] for t in take])
            ids = np.concatenate([t[1] for t in take])
            vals = np.concatenate([t[2] for t in take])
        if hist_len:
            fs = ids.shape[1] - hist_len
            return {
                "feat_ids": np.ascontiguousarray(ids[:, :fs], np.int32),
                "feat_vals": np.ascontiguousarray(vals[:, :fs], np.float32),
                "hist_ids": np.ascontiguousarray(ids[:, fs:], np.int32),
                "hist_mask": np.ascontiguousarray(vals[:, fs:], np.float32),
                "label": np.ascontiguousarray(labels.reshape(-1, 1),
                                              np.float32),
            }
        if labels.ndim == 2 and labels.shape[1] > 1:
            return {
                "feat_ids": np.ascontiguousarray(ids, np.int32),
                "feat_vals": np.ascontiguousarray(vals, np.float32),
                "label": np.ascontiguousarray(labels[:, :1], np.float32),
                "label2": np.ascontiguousarray(labels[:, 1:2], np.float32),
            }
        return {
            "feat_ids": np.ascontiguousarray(ids, np.int32),
            "feat_vals": np.ascontiguousarray(vals, np.float32),
            "label": np.ascontiguousarray(labels.reshape(-1, 1), np.float32),
        }

    # ------------------------------------------------------------------
    # Per-record path
    # ------------------------------------------------------------------
    def _iter_raw_records(self, epoch: int) -> Iterator[bytes]:
        files = self._epoch_files(epoch)
        n_seen = 0
        for path in files:
            for rec in _iter_file_records(path, self._use_native,
                                          self.verify_crc,
                                          policy=self._bad_policy,
                                          retry_policy=self._retry_policy):
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
        return _record_batch(records, self.field_size, self.num_labels,
                             self.history_max_len if self.history else 0)

    def _iter_batches_sync(self) -> Iterator[Batch]:
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

    def _batch_source(self) -> Iterator[Batch]:
        """The pooled path with the native decoder or warm cached columns;
        the per-record path otherwise."""
        if self._use_native or self.decoded_cache != "off":
            loader = _native_loader() if self._use_native else None
            return (rows for rows, _, _ in self._iter_pooled(loader, 1))
        return self._iter_batches_sync()

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch_batches <= 0:
            yield from self._batch_source()
            return
        yield from prefetch(self._batch_source(), self.prefetch_batches)

    def count_examples(self) -> int:
        """One full pass counting records."""
        return sum(1 for _ in self._iter_raw_records(epoch=0))


class ChainedFileStream:
    """Sequential ``read(n)``-only view over a list of files, replayed
    ``num_epochs`` times: the producer side of pipe mode. SageMaker's
    Pipe-mode FIFO replays the channel once per epoch and cannot be
    reopened, so the epochs live with the producer and the consumer
    (:class:`StreamingCtrPipeline`) sees one continuous byte stream. With
    ``shuffle_each_epoch`` each epoch's file order is a seeded reshuffle
    (``default_rng(seed + epoch)``, the epoch continuing across resumed
    invocations through ``epoch_offset``)."""

    def __init__(self, files: Sequence[str], *, num_epochs: int = 1,
                 shuffle_each_epoch: bool = False, seed: int = 42,
                 epoch_offset: int = 0, retry_policy=None,
                 health: Optional[DataHealth] = None):
        if not files:
            raise ValueError("ChainedFileStream needs at least one file")
        self._files: List[str] = []
        for e in range(num_epochs):
            fs = list(files)
            if shuffle_each_epoch:
                np.random.default_rng(seed + e + epoch_offset).shuffle(fs)
            self._files.extend(fs)
        self._idx = 0
        self._fh: Optional[BinaryIO] = None
        self._retry_policy = retry_policy
        self._health = health

    def _open_next(self, path: str) -> BinaryIO:
        # A transient fault heals inside the producer, per file, so the
        # consumer's single-pass stream never breaks.
        on_retry = None
        if self._health is not None:
            health = self._health
            on_retry = lambda exc, n, p=path: health.record_retry(p)  # noqa: E731
        return fileio.open_resilient(path, policy=self._retry_policy,
                                     on_retry=on_retry)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            raise ValueError("ChainedFileStream only supports bounded reads")
        out = bytearray()
        while len(out) < n:
            if self._fh is None:
                if self._idx >= len(self._files):
                    break
                self._fh = self._open_next(self._files[self._idx])
                self._idx += 1
            chunk = self._fh.read(n - len(out))
            if not chunk:
                self._fh.close()
                self._fh = None
                continue
            out += chunk
        return bytes(out)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StreamingCtrPipeline:
    """Pipe mode: batches decoded from one sequential byte stream (a
    :class:`ChainedFileStream`, or the online trainer's
    ``stream.UnboundedFileStream``), in stream order, without shuffle.

    Single pass, as a FIFO: more epochs are the producer's business. With
    the native decoder the stream is framed in ~64 MB reads with a carried
    tail (``_iter_framed_stream``) and decoded chunk by chunk; without it,
    record by record through the Python codec, the same batches.
    ``iter_superbatches(k)`` emits k batches at a time as one contiguous
    block (the staging ring's ``stage_rows`` path); the batch sequence is
    the same for every k, so a resume's ``skip_batches`` lines up across
    both feeds. Corrupt frames go through the bad-record policy, counted in
    ``health`` (shared with the producer's read retries)."""

    def __init__(self, stream: BinaryIO, *, field_size: int,
                 batch_size: int, drop_remainder: bool = True,
                 prefetch_batches: int = 4, use_native_decoder: bool = True,
                 verify_crc: bool = False, skip_batches: int = 0,
                 on_bad_record: str = "raise", max_bad_records: int = 0,
                 stream_label: str = "<stream>",
                 health: Optional[DataHealth] = None, num_labels: int = 1):
        self.stream = stream
        self.field_size = field_size
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.prefetch_batches = prefetch_batches
        self._use_native = bool(use_native_decoder)
        self.verify_crc = verify_crc
        self.skip_batches = skip_batches  # resume: drop the trained prefix
        self._consumed = False
        self.health = health if health is not None else DataHealth()
        self._stream_label = stream_label
        self._bad_policy = BadRecordPolicy(on_bad_record, max_bad_records,
                                           self.health)
        self.num_labels = max(1, int(num_labels))
        if self.num_labels > 2:
            raise ValueError(
                f"num_labels must be 1 or 2, got {num_labels}")
        if self._use_native:
            _native_loader()  # build now: a failed build raises here

    def _take(self) -> None:
        if self._consumed:
            raise RuntimeError(
                "StreamingCtrPipeline is single-pass (Pipe-mode FIFO "
                "semantics); create a new stream for another epoch")
        self._consumed = True

    def _iter_records(self) -> Iterator[bytes]:
        return tfrecord.iter_records_from_stream(
            self.stream, verify_crc=self.verify_crc,
            path=self._stream_label, policy=self._bad_policy)

    def _iter_vectorized_grouped(self, loader, k: int
                                 ) -> Iterator[Tuple[Batch, int, int]]:
        """Native path: chunked framing and vectorized decode straight off
        the stream, emitted as ``(rows, m, n_ex)`` groups of up to ``k``
        batches. No shuffle: the batch sequence is stream order for every
        k, only the grouping differs."""
        bs = self.batch_size
        sb = bs * max(k, 1)
        pend: "collections.deque" = collections.deque()
        n_pend = 0
        for buf, offsets, lengths in _iter_framed_stream(
                self.stream, loader, self.verify_crc,
                path=self._stream_label, policy=self._bad_policy):
            if len(offsets) == 0:
                continue
            if self.num_labels > 1:
                lab1, lab2, ids, vals = loader.decode_spans2(
                    buf, offsets, lengths, self.field_size)
                pend.append((np.stack([lab1, lab2], axis=1), ids, vals))
            else:
                pend.append(loader.decode_spans(buf, offsets, lengths,
                                                self.field_size))
            n_pend += len(offsets)
            while n_pend >= sb:
                yield CtrPipeline._assemble_batch(pend, sb), k, sb
                n_pend -= sb
        while n_pend >= bs:
            yield CtrPipeline._assemble_batch(pend, bs), 1, bs
            n_pend -= bs
        if n_pend and not self.drop_remainder:
            yield CtrPipeline._assemble_batch(pend, n_pend), 1, n_pend

    def _batch_from_records(self, records: List[bytes]) -> Batch:
        return _record_batch(records, self.field_size, self.num_labels)

    def _iter_record_batches(self) -> Iterator[Batch]:
        """Per-record path: Python framing and the codec."""
        pending: List[bytes] = []
        for rec in self._iter_records():
            pending.append(rec)
            if len(pending) == self.batch_size:
                yield self._batch_from_records(pending)
                pending = []
        if pending and not self.drop_remainder:
            yield self._batch_from_records(pending)

    def _iter_sync(self) -> Iterator[Batch]:
        self._take()
        if self._use_native:
            src = (rows for rows, _, _ in self._iter_vectorized_grouped(
                _native_loader(), 1))
        else:
            src = self._iter_record_batches()
        skip = self.skip_batches
        for b in src:
            if skip:
                skip -= 1
                continue
            yield b

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch_batches <= 0:
            return self._iter_sync()
        return prefetch(self._iter_sync(), self.prefetch_batches)

    def iter_superbatches(self, k: int) -> Iterator[Tuple[Batch, int, int]]:
        """The k-batch feed of the fit loop's dispatch (same contract as
        ``CtrPipeline.iter_superbatches``), single-pass like every read of
        the stream."""
        if not self._use_native or k <= 1:
            yield from _group_plain_batches(iter(self), k, self.batch_size)
            return
        self._take()
        src = _trim_skip(self._iter_vectorized_grouped(_native_loader(), k),
                         self.skip_batches, self.batch_size)
        if self.prefetch_batches > 0:
            src = prefetch(src, max(1, self.prefetch_batches // k))
        yield from src


def _record_batch(records: List[bytes], field_size: int, num_labels: int,
                  hist_len: int = 0) -> Batch:
    """One batch of the per-record path through the Python codec, with
    ``label2`` (``num_labels`` 2) or the history columns (``hist_len``)."""
    if num_labels > 1:
        labels, labels2, ids, vals = decode_batch2_python(records, field_size)
        extra = {"label2": labels2.reshape(-1, 1).astype(np.float32)}
    elif hist_len:
        labels, ids, vals, hid, hmask, _ = decode_batch_hist_python(
            records, field_size, hist_len)
        extra = {"hist_ids": np.ascontiguousarray(hid, np.int32),
                 "hist_mask": np.ascontiguousarray(hmask, np.float32)}
    else:
        labels, ids, vals = decode_batch_python(records, field_size)
        extra = {}
    return {"feat_ids": np.ascontiguousarray(ids, np.int32),
            "feat_vals": np.ascontiguousarray(vals, np.float32),
            "label": labels.reshape(-1, 1).astype(np.float32), **extra}


# The live producer threads of every prefetch (see join_prefetch_threads).
_PREFETCH_THREADS: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


def join_prefetch_threads(timeout: float) -> bool:
    """Wait up to ``timeout`` seconds in all for the prefetch producers whose
    consumers have stopped to drop out; True when none is left. A process
    that exits while a daemon producer is still inside a torch call (a
    staging transfer's copy or event sync) can abort in interpreter
    finalization, so the launcher calls this before a preempted exit."""
    deadline = time.monotonic() + timeout
    for t in list(_PREFETCH_THREADS):
        t.join(max(0.0, deadline - time.monotonic()))
    return not any(t.is_alive() for t in list(_PREFETCH_THREADS))


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
    _PREFETCH_THREADS.add(t)
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
