"""Multi-process input service: decode workers and a shared-memory
transport (the port's copy of ``deepfm_tpu.data.workers``).

The pooled pipeline's shuffle, scatter and batch assembly hold the GIL, so
``reader_threads`` stops helping once decode stops being the bottleneck.
This module moves the whole frame+decode stage into worker *processes*:
each worker runs the pipeline's framed-chunk reader
(``pipeline._iter_framed_chunks``: the same chunking, CRC policy, retry
healing and bad-record accounting as in process) and decodes straight
into :mod:`shm_ring` slabs; the trainer process reads zero-copy
``np.frombuffer`` views and feeds them to the unchanged shuffle-pool drain.

Workers are spawned, never forked: the trainer owns a CUDA context that a
forked child must not inherit. A spawned child imports this module, so its
import chain (``data.pipeline``, ``native.loader``, ``_native``,
``data.health``, ``obs``, ``utils.retry``, ``config`` and the package's
``__init__``) stays free of torch: a worker never pays for importing torch
and never touches the card.

Determinism contract (the emission is bit-identical to the in-process
path's):

  * File ``i`` of the epoch-shuffled list goes to worker ``i % W`` (static
    round-robin, so the assignment is a pure function of the file list).
  * The consumer iterates files in the SAME epoch-shuffled global order the
    in-process path uses, pulling each file's chunks from its owner's ring.
    Chunks within a file arrive in file order (SPSC ring, ordered queue),
    so the reassembled chunk stream is exactly the in-process
    ``_iter_framed_chunks`` stream: same records, same order, same chunk
    boundaries (fragments are reassembled before yielding).
  * Every data/control message consumes one monotonically increasing
    sequence number per worker. A respawned worker replays its full file
    list but only *emits* messages with ``seq >= start_seq``, which makes
    crash recovery replay-exact.

Worker death: detected via queue-timeout + ``Process.is_alive``. Policy
``raise`` (default) fails the epoch; ``respawn`` restarts the worker on a
FRESH ring at the first sequence number of the incomplete chunk (bounded by
``max_respawns``). Health caveats of respawn: the replacement re-reads the
dead worker's files from the start, so ``DataHealth`` retry/bad-record
counters for already-delivered chunks can be counted twice; the bad-record
skip budget is enforced per worker, not globally. A worker alive but
silent for ``stall_timeout_s`` (``--dispatch_timeout_s``) raises
:class:`InputStallError`.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue as _queue
import sys
import threading
import traceback
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import trace as trace_lib
from . import shm_ring
from .health import BadRecordPolicy, DataHealth

# Spawn, not fork: the trainer process owns a CUDA context (and threads)
# that must not leak into decode workers; spawned children import only the
# numpy-level ``data`` stack.
_MP_CTX = "spawn"

# Default slab sizing: one slab should hold a full reader chunk (64MB of
# on-disk bytes is < ~210k Criteo-shaped records) so the common case is one
# zero-copy fragment per chunk; fragmentation beyond that is correct, just
# one concatenate-copy slower.
_DEFAULT_SLAB_BYTES = 64 << 20
_DEFAULT_CAPACITY = 4


_MAIN_LOCK = threading.Lock()


@contextlib.contextmanager
def _main_module_hidden():
    """Hide the parent's ``__main__`` from spawn while a worker starts.

    Spawn's preparation data tells the child to import the parent's main
    module (a training script, or ``deepfm_tpu_torch.launch`` under ``-m``)
    before it unpickles its target, and a trainer's main imports torch:
    seconds a spawn, a respawn included. The worker needs none of it; with
    the main module's name and path hidden the child imports only this
    module's chain."""
    main = sys.modules["__main__"]
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__")
             if k in main.__dict__}
    with _MAIN_LOCK:
        main.__spec__ = None
        main.__dict__.pop("__file__", None)
        try:
            yield
        finally:
            main.__dict__.update(saved)


def default_slab_records(field_size: int) -> int:
    row_bytes = 4 + 8 * field_size  # f32 label + (i32 + f32) * field
    return max(1, _DEFAULT_SLAB_BYTES // row_bytes)


def _policy_scalars(policy) -> Optional[Dict[str, Any]]:
    """Picklable retry knobs for spawn args (callables stay behind)."""
    if policy is None:
        return None
    return dict(max_attempts=policy.max_attempts,
                base_delay=policy.base_delay,
                max_delay=policy.max_delay,
                deadline=policy.deadline,
                jitter_seed=policy.jitter_seed)


def _snapshot_delta(prev: Dict[str, Any], cur: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """cur - prev over cumulative DataHealth snapshots."""
    delta: Dict[str, Any] = {
        key: int(cur[key]) - int(prev.get(key, 0))
        for key in ("read_retries", "bad_records", "truncated_tails",
                    "bytes_discarded")}
    per_file: Dict[str, Dict[str, int]] = {}
    for path, c in cur.get("per_file", {}).items():
        p = prev.get("per_file", {}).get(path, {})
        d = {k: int(c[k]) - int(p.get(k, 0)) for k in ("retries", "skipped")}
        if any(d.values()):
            per_file[path] = d
    delta["per_file"] = per_file
    return delta


def worker_main(worker_id: int, handle: shm_ring.RingHandle,
                files: Sequence[Tuple[int, str]], opts: Dict[str, Any]
                ) -> None:
    """Decode worker entry point (module-level: spawn pickles by reference).

    Streams each assigned ``(global_file_idx, path)`` through the shared
    framed-chunk reader, splits every chunk into <= slab_records fragments,
    decodes each fragment straight into a ring slab, and publishes
    ``("chunk", seq, slot, file_idx, n_records, last_fragment)``. File
    boundaries publish ``("eof", seq, file_idx, health_snapshot)``; normal
    completion ``("done", seq, worker_id, health_snapshot)``; any failure
    ``("error", seq, worker_id, exc_type, detail, health_snapshot)``.
    """
    ring = shm_ring.ShmRing.attach(handle)
    trace_lib.configure_from_env()  # inherit the parent's --trace settings
    seq = 0
    start_seq = int(opts.get("start_seq", 0))
    die_after = opts.get("fault_die_after")
    emitted = 0
    health = DataHealth()
    try:
        policy = BadRecordPolicy(opts["on_bad_record"],
                                 opts["max_bad_records"], health)
        retry_policy = None
        if opts.get("retry") is not None:
            from ..utils.retry import RetryPolicy  # noqa: PLC0415
            retry_policy = RetryPolicy(**opts["retry"])
        from . import pipeline as pipe_mod  # noqa: PLC0415
        loader = pipe_mod._native_loader()
        S = handle.slab_records
        F = handle.field_size
        for fidx, path in files:
            for buf, offsets, lengths in pipe_mod._iter_framed_chunks(
                    path, loader, opts["verify_crc"], policy=policy,
                    retry_policy=retry_policy):
                total = len(offsets)
                if total == 0:
                    continue
                for s in range(0, total, S):
                    e = min(s + S, total)
                    if seq >= start_seq:
                        with trace_lib.span("input.slab_wait", worker=worker_id):
                            slot = ring.acquire()  # blocks = backpressure
                        n = e - s
                        labels, ids, vals = ring.arrays(slot, n)
                        with trace_lib.span("input.decode", worker=worker_id,
                                            records=n):
                            loader.decode_spans_scatter(
                                buf, offsets[s:e], lengths[s:e], F,
                                np.arange(n, dtype=np.int64), labels, ids, vals)
                        del labels, ids, vals
                        ring.send(("chunk", seq, slot, fidx, n, e == total))
                        emitted += 1
                        if die_after is not None \
                                and emitted >= int(die_after):
                            os._exit(13)  # test hook: simulated hard crash
                    seq += 1
            if seq >= start_seq:
                ring.send(("eof", seq, fidx, health.snapshot()))
            seq += 1
        ring.send(("done", seq, worker_id, health.snapshot()))
    except BaseException as exc:  # noqa: BLE001 — forwarded to the trainer
        try:
            ring.send(("error", seq, worker_id, type(exc).__name__,
                       f"{exc}\n{traceback.format_exc()}", health.snapshot()))
        except Exception:
            pass
        trace_lib.export()
        ring.close()
        sys.exit(1)
    trace_lib.export()  # one trace-<pid>.json per worker; parent merges
    ring.close()


class _WorkerDied(Exception):
    """Internal: worker process exited without a protocol farewell."""


class InputStallError(RuntimeError):
    """An input worker is alive but produced nothing for stall_timeout_s.

    Distinct from ``_WorkerDied`` (process gone) — this is the wedged-but-
    breathing case: a hung filesystem mount, a deadlocked decoder, a worker
    blocked on a ring slot the consumer will never free. Raising (instead of
    polling forever) surfaces the stall with diagnostics so a supervisor can
    restart the job rather than letting it burn accelerator reservations
    silently."""


class ShmInputService:
    """Parent-side fleet manager + globally-ordered chunk iterator.

    Context manager: ``__enter__`` spawns the fleet, ``__exit__`` tears it
    down (terminate + join + unlink every segment), safe on abandonment
    mid-epoch (GeneratorExit in the consumer lands in ``__exit__``).
    """

    def __init__(self, files: Sequence[str], *, field_size: int,
                 num_workers: int, slab_records: Optional[int] = None,
                 capacity: int = _DEFAULT_CAPACITY, verify_crc: bool = False,
                 on_bad_record: str = "raise", max_bad_records: int = 0,
                 retry_policy=None, health: Optional[DataHealth] = None,
                 on_worker_death: str = "raise", max_respawns: int = 2,
                 poll_secs: float = 0.2, fault_die_after: Optional[int] = None,
                 stall_timeout_s: float = 0.0):
        if on_worker_death not in ("raise", "respawn"):
            raise ValueError(
                f"on_worker_death must be 'raise' or 'respawn', "
                f"got {on_worker_death!r}")
        self._files: Tuple[str, ...] = tuple(files)
        self.field_size = field_size
        self.num_workers = max(1, min(int(num_workers), len(self._files))) \
            if self._files else 0
        self.slab_records = int(slab_records if slab_records is not None
                                else default_slab_records(field_size))
        self.capacity = int(capacity)
        self._opts: Dict[str, Any] = dict(
            verify_crc=verify_crc, on_bad_record=on_bad_record,
            max_bad_records=max_bad_records,
            retry=_policy_scalars(retry_policy),
            fault_die_after=fault_die_after)
        self.health = health if health is not None else DataHealth()
        self.on_worker_death = on_worker_death
        self.max_respawns = int(max_respawns)
        self._poll_secs = poll_secs
        self._stall_timeout_s = float(stall_timeout_s)
        self._ctx = mp.get_context(_MP_CTX)
        self._rings: List[shm_ring.ShmRing] = []
        self._procs: List[Optional[mp.process.BaseProcess]] = []
        self._expected: List[int] = []       # next seq per worker
        self._chunk_start: List[int] = []    # restart seq of the open chunk
        self._held: List[List[Tuple[shm_ring.ShmRing, int]]] = []
        self._last_snap: List[Dict[str, Any]] = []
        self._retired: List[shm_ring.ShmRing] = []
        self._respawns = 0
        self._started = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def _assignment(self, w: int) -> List[Tuple[int, str]]:
        return [(i, path) for i, path in enumerate(self._files)
                if i % self.num_workers == w]

    def _spawn(self, w: int, start_seq: int) -> None:
        spec = shm_ring.SlabSpec(self.slab_records, self.field_size)
        ring = shm_ring.ShmRing.create(spec, self.capacity, self._ctx)
        try:
            opts = dict(self._opts, start_seq=start_seq)
            proc = self._ctx.Process(
                target=worker_main, name=f"dfm-input-{w}",
                args=(w, ring.handle, self._assignment(w), opts), daemon=True)
            with _main_module_hidden():
                proc.start()
        except BaseException:
            ring.close()  # owner: unlinks the segment
            raise
        self._rings[w] = ring
        self._procs[w] = proc
        self._expected[w] = start_seq
        self._chunk_start[w] = start_seq
        self._last_snap[w] = {}

    def start(self) -> "ShmInputService":
        if self._started:
            return self
        self._started = True
        W = self.num_workers
        self._rings = [None] * W  # type: ignore[list-item]
        self._procs = [None] * W
        self._expected = [0] * W
        self._chunk_start = [0] * W
        self._held = [[] for _ in range(W)]
        self._last_snap = [{} for _ in range(W)]
        try:
            for w in range(W):
                self._spawn(w, start_seq=0)
        except BaseException:
            self.close()
            raise
        return self

    def __enter__(self) -> "ShmInputService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for proc in self._procs:
            if proc is not None and proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            if proc is not None:
                proc.join(timeout=10)
        for ring in list(self._rings) + self._retired:
            if ring is not None:
                ring.close()

    # -- health ---------------------------------------------------------
    def _merge_health(self, w: int, snap: Dict[str, Any]) -> None:
        self.health.apply_delta(_snapshot_delta(self._last_snap[w], snap))
        self._last_snap[w] = snap

    # -- message pump ---------------------------------------------------
    def _pop(self, w: int) -> Tuple:
        ring = self._rings[w]
        waited = 0.0
        # Async span opened lazily on the first empty poll: the common
        # message-ready case never allocates a trace event.
        sp = None
        try:
            while True:
                try:
                    return ring.pop(timeout=self._poll_secs)
                except _queue.Empty:
                    if sp is None:
                        sp = trace_lib.begin("input.ring_wait", worker=w)
                proc = self._procs[w]
                if proc is None or not proc.is_alive():
                    try:  # messages flushed just before death are still valid
                        return ring.pop(timeout=0)
                    except _queue.Empty:
                        raise _WorkerDied(w) from None
                waited += self._poll_secs
                if self._stall_timeout_s > 0 \
                        and waited >= self._stall_timeout_s:
                    raise InputStallError(
                        f"input worker {w} is alive but produced no message "
                        f"for {waited:.1f}s (stall_timeout_s="
                        f"{self._stall_timeout_s:g}); data health: "
                        f"{self.health.summary()}")
        finally:
            trace_lib.end(sp)

    def _next_msg(self, w: int) -> Tuple:
        msg = self._pop(w)
        if msg[0] == "error":
            _, seq, _, exc_type, detail, snap = msg
            self._merge_health(w, snap)
            text = f"input worker {w} failed: {detail}"
            if exc_type in ("IOError", "OSError"):
                raise IOError(text)  # keeps bad-record-budget parity
            if exc_type == "ValueError":
                raise ValueError(text)
            raise RuntimeError(text)
        if msg[1] != self._expected[w]:
            raise RuntimeError(
                f"input worker {w} protocol violation: message seq "
                f"{msg[1]}, expected {self._expected[w]}")
        self._expected[w] += 1
        return msg

    def _on_death(self, w: int) -> None:
        proc = self._procs[w]
        code = proc.exitcode if proc is not None else None
        if self.on_worker_death != "respawn" \
                or self._respawns >= self.max_respawns:
            raise RuntimeError(
                f"input worker {w} died (exit code {code}); "
                f"on_worker_death={self.on_worker_death!r}, "
                f"respawns used {self._respawns}/{self.max_respawns}")
        self._respawns += 1
        # The crash knob injects ONE fault: replacements spawn healthy.
        # (os._exit can kill the queue feeder before anything flushed, so
        # the replacement may replay from seq 0 — were the knob still
        # armed it would re-crash at the same spot every incarnation.)
        self._opts["fault_die_after"] = None
        # Fresh ring: slots lost in the dead worker's hands (acquired but
        # never committed, or queued messages that never flushed) cannot be
        # recovered from the old segment's bookkeeping. Views the consumer
        # still holds keep referencing the retired segment until
        # release_consumed(); it is unlinked at service close.
        self._retired.append(self._rings[w])
        self._spawn(w, start_seq=self._chunk_start[w])

    # -- the consumer API ----------------------------------------------
    def chunks(self, *, copy: bool = False
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Decoded ``(labels, ids, vals)`` chunks in GLOBAL file order —
        the exact stream ``CtrPipeline._iter_decoded_chunks`` would
        produce in-process. With ``copy=False`` single-fragment chunks are
        zero-copy slab views, held until :meth:`release_consumed`; to stay
        deadlock-free the hold is bounded at ``capacity - 2`` slabs per
        worker, past which chunks are copied and their slots released
        immediately (a consumer pooling more rows than the rings hold must
        not starve the producers)."""
        if not self._started:
            raise RuntimeError("service not started (use 'with service:')")
        got_any = False
        for fidx in range(len(self._files)):
            w = fidx % self.num_workers
            frags: List[Tuple[int, Tuple[np.ndarray, ...]]] = []
            while True:
                try:
                    msg = self._next_msg(w)
                except _WorkerDied:
                    self._on_death(w)  # raises unless respawn allowed
                    frags = []  # partial chunk replays from _chunk_start
                    continue
                kind = msg[0]
                if kind == "chunk":
                    _, _, slot, m_fidx, n, last = msg
                    if m_fidx != fidx:
                        raise RuntimeError(
                            f"input worker {w} protocol violation: chunk "
                            f"for file {m_fidx}, expected {fidx}")
                    frags.append((slot, self._rings[w].arrays(slot, n)))
                    if not last:
                        continue
                    got_any = True
                    yield self._assemble(w, frags, copy)
                    frags = []
                    self._chunk_start[w] = self._expected[w]
                elif kind == "eof":
                    _, _, m_fidx, snap = msg
                    if frags or m_fidx != fidx:
                        raise RuntimeError(
                            f"input worker {w} protocol violation: eof of "
                            f"file {m_fidx} with open chunk for {fidx}")
                    self._merge_health(w, snap)
                    self._chunk_start[w] = self._expected[w]
                    break
                else:
                    raise RuntimeError(
                        f"input worker {w} protocol violation: unexpected "
                        f"{kind!r} message before eof of file {fidx}")
        for w in range(self.num_workers):
            try:
                while True:
                    msg = self._next_msg(w)
                    if msg[0] == "done":
                        self._merge_health(w, msg[3])
                        break
                    raise RuntimeError(
                        f"input worker {w} protocol violation: expected "
                        f"'done', got {msg[0]!r}")
            except _WorkerDied:
                pass  # every file already delivered; the farewell is lost
        if not got_any and self._files:
            raise IOError(f"no records found in {len(self._files)} files")

    def _assemble(self, w: int, frags, copy: bool
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ring = self._rings[w]
        if (not copy and len(frags) == 1
                and len(self._held[w]) < self.capacity - 2):
            slot, arrays = frags[0]
            self._held[w].append((ring, slot))
            return arrays
        if len(frags) == 1:
            slot, (labels, ids, vals) = frags[0]
            out = (labels.copy(), ids.copy(), vals.copy())
            ring.release(slot)
            return out
        labels = np.concatenate([f[1][0] for f in frags])
        ids = np.concatenate([f[1][1] for f in frags])
        vals = np.concatenate([f[1][2] for f in frags])
        for slot, _ in frags:
            ring.release(slot)
        return labels, ids, vals

    def release_consumed(self) -> None:
        """Return every held slab to its producer. The pipeline calls this
        right after the shuffle-pool drain scatters the held views into
        fresh pool arrays — from that point the slab memory is dead weight
        and the worker may overwrite it."""
        for w in range(self.num_workers):
            for ring, slot in self._held[w]:
                if ring is self._rings[w]:  # retired rings have no reader
                    ring.release(slot)
            self._held[w] = []
