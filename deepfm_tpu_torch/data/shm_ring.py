"""Shared-memory slab ring: the transport of the multi-process input service
(the port's copy of ``deepfm_tpu.data.shm_ring``).

One ring pairs ONE producer (a decode worker process) with ONE consumer (the
trainer process). A single ``SharedMemory`` segment is partitioned into
``capacity`` fixed-size *slabs*; each slab holds one decoded chunk (or chunk
fragment) as three contiguous arrays::

    labels  float32[S]            offset 0
    ids     int32  [S, F]         offset 4*S
    vals    float32[S, F]         offset 4*S + 4*S*F

(S = ``slab_records``, F = ``field_size``). Decoded rows never cross the
process boundary through a pickle: the worker decodes straight into a slab
(``decode_spans_scatter``) and sends only a slot *index*; the consumer maps
the same segment and reads ``np.frombuffer`` views.

Credit/sequence protocol (strictly SPSC per ring):

  * ``free_q`` holds slot indices the producer may write, preloaded with all
    ``capacity`` slots. The producer blocking on an empty ``free_q`` IS the
    backpressure: a stalled trainer stops the decode fleet with at most
    ``capacity`` slabs in flight. Free slots are a *set*, not a cursor — the
    consumer may hold shuffle-pool slabs long after later slots recycle.
  * ``filled_q`` carries producer->consumer messages in production order.
    The ring does not interpret them beyond slot bookkeeping; the worker
    protocol (workers.py) stamps each with a monotonically increasing
    sequence number, which is what makes a respawned worker able to skip
    exactly the chunks the consumer already received.

The queue *type* is injectable (``ctx``): production uses a spawn
``multiprocessing`` context; unit tests pass a thread context
(``THREAD_CTX``) so wraparound/backpressure tests are deterministic and
sleep-free.
"""

from __future__ import annotations

import dataclasses
import os
import queue as _queue
from multiprocessing import shared_memory
from typing import Any, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SlabSpec:
    """Geometry of one slab (shared by producer and consumer)."""

    slab_records: int
    field_size: int

    def __post_init__(self) -> None:
        if self.slab_records <= 0:
            raise ValueError("slab_records must be positive")
        if self.field_size <= 0:
            raise ValueError("field_size must be positive")

    @property
    def labels_bytes(self) -> int:
        return 4 * self.slab_records

    @property
    def ids_bytes(self) -> int:
        return 4 * self.slab_records * self.field_size

    @property
    def slab_bytes(self) -> int:
        # labels + ids + vals (ids and vals are the same size).
        return self.labels_bytes + 2 * self.ids_bytes


class _ThreadCtx:
    """Queue factory making the ring run in-process (tests)."""

    @staticmethod
    def Queue() -> "_queue.Queue":
        return _queue.Queue()


THREAD_CTX = _ThreadCtx()


@dataclasses.dataclass
class RingHandle:
    """Picklable attach token: everything a worker needs to join a ring.

    The queues themselves are mp.Queue objects, picklable only through
    ``Process(args=...)`` inheritance — exactly how workers receive them.
    """

    name: str
    slab_records: int
    field_size: int
    capacity: int
    free_q: Any
    filled_q: Any


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment WITHOUT registering it with this
    process's resource_tracker (bpo-38119: before 3.13 every attach
    registers, so the first attaching process to exit unlinks the segment
    under the owner and the tracker spams KeyError warnings). Ownership
    stays with the creating process, which keeps default tracking — a
    hard-crashed trainer still gets its segments reaped."""
    from multiprocessing import resource_tracker  # noqa: PLC0415

    orig = resource_tracker.register

    def register(rt_name: str, rtype: str) -> None:
        if rtype == "shared_memory":
            return
        orig(rt_name, rtype)

    resource_tracker.register = register
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class ShmRing:
    """One producer/consumer slab ring over a SharedMemory segment."""

    def __init__(self, shm: shared_memory.SharedMemory, spec: SlabSpec,
                 capacity: int, free_q: Any, filled_q: Any, *, owner: bool):
        self._shm = shm
        self.spec = spec
        self.capacity = capacity
        self.free_q = free_q
        self.filled_q = filled_q
        self._owner = owner
        self._closed = False

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, spec: SlabSpec, capacity: int, ctx: Any) -> "ShmRing":
        if capacity < 2:
            # One slot in flight + one being filled is the minimum that
            # lets the producer work while the consumer reads.
            raise ValueError("ring capacity must be >= 2")
        shm = shared_memory.SharedMemory(
            create=True, size=capacity * spec.slab_bytes)
        try:
            free_q = ctx.Queue()
            filled_q = ctx.Queue()
            for slot in range(capacity):
                free_q.put(slot)
        except BaseException:
            shm.close()
            shm.unlink()
            raise
        return cls(shm, spec, capacity, free_q, filled_q, owner=True)

    @classmethod
    def attach(cls, handle: RingHandle) -> "ShmRing":
        shm = _attach_untracked(handle.name)
        spec = SlabSpec(handle.slab_records, handle.field_size)
        return cls(shm, spec, handle.capacity, handle.free_q,
                   handle.filled_q, owner=False)

    @property
    def handle(self) -> RingHandle:
        return RingHandle(self._shm.name, self.spec.slab_records,
                          self.spec.field_size, self.capacity,
                          self.free_q, self.filled_q)

    # -- slab access ----------------------------------------------------
    def arrays(self, slot: int, n: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(labels[n], ids[n,F], vals[n,F]) views over slab ``slot``.

        Views alias the shared segment directly — valid until the slot is
        released back to the producer (consumer side) or committed
        (producer side). Callers needing longer-lived rows must copy.
        """
        spec = self.spec
        if not 0 <= slot < self.capacity:
            raise IndexError(f"slot {slot} out of range 0..{self.capacity - 1}")
        if not 0 < n <= spec.slab_records:
            raise ValueError(
                f"n={n} rows does not fit slab_records={spec.slab_records}")
        base = slot * spec.slab_bytes
        buf = self._shm.buf
        F = spec.field_size
        labels = np.frombuffer(buf, np.float32, count=n, offset=base)
        ids = np.frombuffer(buf, np.int32, count=n * F,
                            offset=base + spec.labels_bytes).reshape(n, F)
        vals = np.frombuffer(
            buf, np.float32, count=n * F,
            offset=base + spec.labels_bytes + spec.ids_bytes).reshape(n, F)
        return labels, ids, vals

    # -- producer side --------------------------------------------------
    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next writable slot; None on timeout (0 = non-blocking probe)."""
        try:
            if timeout == 0:
                return self.free_q.get_nowait()
            return self.free_q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def send(self, msg: Any) -> None:
        """Publish a message (a committed slot or a control event)."""
        self.filled_q.put(msg)

    # -- consumer side --------------------------------------------------
    def pop(self, timeout: Optional[float] = None) -> Any:
        """Next producer message; raises queue.Empty on timeout."""
        if timeout == 0:
            return self.filled_q.get_nowait()
        return self.filled_q.get(timeout=timeout)

    def release(self, slot: int) -> None:
        """Return a consumed slot to the producer (any order)."""
        if not 0 <= slot < self.capacity:
            raise IndexError(f"slot {slot} out of range 0..{self.capacity - 1}")
        self.free_q.put(slot)

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Unmap the segment (owner also unlinks). Never raises: live
        ``arrays()`` views hold exported pointers, which makes mmap close
        a BufferError — the views' GC finishes the unmap later, and the
        unlink below already guarantees the segment is reclaimed."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except BufferError:
            # numpy views still alias the mapping, so mmap.close() refuses
            # ("exported pointers exist"). SharedMemory.close() raised
            # before reaching its os.close, and its __del__ would retry at
            # GC and spam unraisables — so finish the job by hand: close
            # the fd now, drop the wrapper's mmap reference, and let the
            # mapping deallocate silently once the last view dies.
            fd = getattr(self._shm, "_fd", -1)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                self._shm._fd = -1
            self._shm._mmap = None
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
