"""Multi-process serving frontend: N client processes, one device owner
(the port's copy of ``deepfm_tpu.serve.frontend``).

The card belongs to one process; request traffic comes from many. This
module reuses the :mod:`deepfm_tpu_torch.data.shm_ring` SPSC slab machinery
(the input service's transport) to let N client processes feed the one
device-owning server process without pickling a row:

  * per client, a **request ring** (client→server; ids/vals written straight
    into the slab) and a **response ring** (server→client; probs in the
    slab's label array, ``field_size=1`` so the segment stays small);
  * the server loop drains request rings round-robin into the
    :class:`~deepfm_tpu_torch.serve.engine.ServingEngine` (copying rows out of
    the slab so the slot recycles immediately), and writes responses as the
    engine's futures resolve — demuxed by per-client ``req_id``, so clients
    may pipeline;
  * **backpressure end to end** — a full request ring blocks the client's
    ``acquire`` (bounded, timeout → typed error) and a full engine queue
    comes back as an ``("err", ..., "ServerOverloaded", ...)`` response;
  * **crash-safe shutdown** — clients announce ``bye``; the server retires
    them and exits when every client left and no response is owed. A client
    that dies WITHOUT a farewell is detected via the injectable
    ``client_alive`` probe when its response ring stops draining: its
    responses are dropped and it is retired (the input-worker death-policy
    analog).
  * **wedge detection** — a
    :class:`~deepfm_tpu_torch.train.guard.StallWatchdog` beats on every served response (and while fully idle); a predict or a
    response write wedged past ``timeout_s`` aborts with the exit-43
    contract from ``utils/preempt.py``, so a supervisor restarts the server
    instead of letting it squat on the card.

Clients import only numpy + the ring protocol, so a spawned client process
stays light: the engine imports torch only when one is built, and the
watchdog (``train.guard`` imports torch) is imported inside
:meth:`FrontendServer.serve`, on the server's side only. Spawning hides the
parent's main module
(:func:`~deepfm_tpu_torch.data.workers._main_module_hidden`), so a client does not re-import a script that loads torch either.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as _queue
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..data import shm_ring
from .admission import AdmissionShed
from .engine import ServeTimeout, ServerOverloaded, ServingEngine

_MP_CTX = "spawn"   # as data/workers.py: no CUDA context leaks into clients
_DEFAULT_CAPACITY = 4


@dataclasses.dataclass
class FrontendHandle:
    """Picklable attach token for one client (ring pair + geometry)."""

    client_id: int
    field_size: int
    max_rows: int
    request: shm_ring.RingHandle
    response: shm_ring.RingHandle


class ServingClient:
    """Client-side stub: ``predict()`` over the shared-memory ring pair.

    One client object per process/thread (the rings are SPSC). Requests may
    be pipelined (``submit`` then ``recv``); ``predict`` is the synchronous
    convenience. Not thread-safe — one submitter per handle, by design.
    """

    def __init__(self, handle: FrontendHandle):
        self._h = handle
        self._req = shm_ring.ShmRing.attach(handle.request)
        self._resp = shm_ring.ShmRing.attach(handle.response)
        self._next_id = 0
        self._pending: Dict[int, int] = {}   # req_id -> expected rows
        self._done: Dict[int, np.ndarray] = {}
        self._closed = False

    # ---------------------------------------------------------- pipelined
    def submit(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
               timeout: Optional[float] = None,
               trace_id: Optional[int] = None) -> int:
        """Write one request into the ring; returns its ``req_id``.
        ``trace_id`` (``obs.trace.new_trace_id``) rides the wire tuple to
        the engine for request→model-version correlation. Raises
        :class:`ServerOverloaded` when the ring is full past ``timeout``
        (bounded backpressure, never silent drop)."""
        if self._closed:
            raise RuntimeError("client is closed")
        ids = np.asarray(feat_ids)
        vals = np.asarray(feat_vals)
        if ids.ndim != 2 or vals.shape != ids.shape \
                or ids.shape[1] != self._h.field_size:
            raise ValueError(
                f"expected [n, {self._h.field_size}] feat_ids/feat_vals, "
                f"got {ids.shape} / {vals.shape}")
        n = int(ids.shape[0])
        if not 1 <= n <= self._h.max_rows:
            raise ValueError(
                f"request of {n} rows outside 1..{self._h.max_rows}")
        slot = self._req.acquire(timeout=timeout)
        if slot is None:
            raise ServerOverloaded(
                f"request ring full ({self._req.capacity} slabs in flight); "
                "retry with backoff")
        _, slab_ids, slab_vals = self._req.arrays(slot, n)
        slab_ids[:] = ids
        slab_vals[:] = vals
        req_id = self._next_id
        self._next_id += 1
        self._pending[req_id] = n
        # 5th element is optional on the wire: old servers unpack 4 and a
        # None id is simply not sent, so mixed-version rings stay valid.
        if trace_id is None:
            self._req.send(("req", req_id, slot, n))
        else:
            self._req.send(("req", req_id, slot, n, int(trace_id)))
        return req_id

    def recv(self, req_id: int,
             timeout: Optional[float] = None) -> np.ndarray:
        """Block for the probs of ``req_id`` (out-of-order safe)."""
        if req_id in self._done:
            return self._done.pop(req_id)
        if req_id not in self._pending:
            raise KeyError(f"unknown req_id {req_id}")
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                msg = self._resp.pop(timeout=remaining)
            except _queue.Empty:
                raise TimeoutError(
                    f"no response for req_id {req_id} within {timeout}s"
                ) from None
            if msg[0] == "resp":
                _, rid, slot, n = msg
                probs, _, _ = self._resp.arrays(slot, n)
                out = probs.copy()
                self._resp.release(slot)
                self._pending.pop(rid, None)
                if rid == req_id:
                    return out
                self._done[rid] = out
            elif msg[0] == "err":
                _, rid, exc_type, detail = msg
                self._pending.pop(rid, None)
                err: Exception
                if exc_type == "ServerOverloaded":
                    err = ServerOverloaded(detail)
                elif exc_type == "AdmissionShed":
                    err = AdmissionShed(detail)
                elif exc_type == "ServeTimeout":
                    err = ServeTimeout(detail)
                elif exc_type == "ValueError":
                    err = ValueError(detail)
                else:
                    err = RuntimeError(f"{exc_type}: {detail}")
                if rid == req_id:
                    raise err
                # An error for a *different* pipelined request: surface it
                # on that request's recv by stashing the exception.
                self._done[rid] = err  # type: ignore[assignment]
            else:
                raise RuntimeError(
                    f"serving protocol violation: unexpected {msg[0]!r}")

    # ---------------------------------------------------------- one-shot
    def predict(self, feat_ids: np.ndarray, feat_vals: np.ndarray,
                timeout: Optional[float] = None,
                trace_id: Optional[int] = None) -> np.ndarray:
        out = self.recv(
            self.submit(feat_ids, feat_vals, timeout, trace_id=trace_id),
            timeout)
        if isinstance(out, Exception):
            raise out
        return out

    def close(self) -> None:
        """Announce the farewell; the server retires this client."""
        if self._closed:
            return
        self._closed = True
        try:
            self._req.send(("bye", self._h.client_id))
        except Exception:
            pass  # server gone: the alive-probe path cleans up
        self._req.close()
        self._resp.close()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def client_main(handle: FrontendHandle, num_requests: int,
                max_rows: int, feature_size: int, seed: int) -> None:
    """Spawned-client entry point (module-level: spawn pickles by
    reference): fire ``num_requests`` random-size requests, assert finite
    correctly-shaped probs, exit 0. Any failure exits nonzero."""
    client = ServingClient(handle)
    rng = np.random.default_rng(seed)
    try:
        for _ in range(int(num_requests)):
            n = int(rng.integers(1, max_rows + 1))
            ids = rng.integers(0, feature_size,
                               (n, handle.field_size)).astype(np.int32)
            vals = rng.normal(size=(n, handle.field_size)).astype(np.float32)
            probs = client.predict(ids, vals, timeout=120.0)
            assert probs.shape == (n,) and np.all(np.isfinite(probs)), (
                f"bad response shape/values: {probs.shape}")
        client.close()
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.exit(1)


class FrontendServer:
    """Device-owning side: ring pairs + the drain/respond loop."""

    def __init__(self, engine: ServingEngine, num_clients: int, *,
                 field_size: int, slab_records: Optional[int] = None,
                 capacity: int = _DEFAULT_CAPACITY, ctx: Any = None,
                 poll_secs: float = 0.005, timeout_s: float = 0.0,
                 request_timeout_s: float = 0.0,
                 abort: Optional[Callable[[str], None]] = None,
                 client_alive: Optional[Callable[[int], bool]] = None):
        if num_clients < 1:
            raise ValueError("num_clients must be >= 1")
        if request_timeout_s < 0:
            raise ValueError(
                f"request_timeout_s must be >= 0, got {request_timeout_s}")
        self._engine = engine
        # A replicated engine routes by client id (sticky affinity with
        # least-loaded spill); a single engine ignores the concept.
        self._affinity = bool(getattr(engine, "supports_affinity", False))
        self.num_clients = int(num_clients)
        self.field_size = int(field_size)
        self.max_rows = int(slab_records if slab_records is not None
                            else engine.max_batch)
        self._poll = float(poll_secs)
        self._timeout_s = float(timeout_s)
        # Per-request response budget (0 = wait forever, the legacy
        # behavior): a future pending past this is answered with a typed
        # ServeTimeout error instead of wedging the client — derived from
        # --serve_timeout_s by callers that pass a config.
        self._request_timeout_s = float(request_timeout_s)
        self._abort = abort
        self._client_alive = client_alive
        self.responses_sent = 0
        self.errors_sent = 0
        self.timeouts_sent = 0
        self.dropped_dead_client = 0
        # perf_counter of the first request read and of the last response
        # sent: the serving window, apart from the clients' start.
        self.first_request_t: Optional[float] = None
        self.last_response_t: Optional[float] = None
        ctx = ctx if ctx is not None else mp.get_context(_MP_CTX)
        self._ctx = ctx
        req_spec = shm_ring.SlabSpec(self.max_rows, self.field_size)
        resp_spec = shm_ring.SlabSpec(self.max_rows, 1)
        self._req_rings: List[shm_ring.ShmRing] = []
        self._resp_rings: List[shm_ring.ShmRing] = []
        try:
            for _ in range(self.num_clients):
                self._req_rings.append(
                    shm_ring.ShmRing.create(req_spec, capacity, ctx))
                self._resp_rings.append(
                    shm_ring.ShmRing.create(resp_spec, capacity, ctx))
        except BaseException:
            self.close()
            raise
        self._alive = [True] * self.num_clients
        # (future, client_id, req_id) in submission order; completion may
        # resolve out of order but each client demuxes by req_id.
        self._inflight: deque = deque()
        self._stop_flag = False

    # ----------------------------------------------------------- plumbing
    def handle(self, client_id: int) -> FrontendHandle:
        return FrontendHandle(
            client_id=client_id, field_size=self.field_size,
            max_rows=self.max_rows,
            request=self._req_rings[client_id].handle,
            response=self._resp_rings[client_id].handle)

    def handles(self) -> List[FrontendHandle]:
        return [self.handle(c) for c in range(self.num_clients)]

    def spawn_client(self, client_id: int, *args: Any,
                     target: Callable[..., None] = client_main):
        """Start ``target(handle(client_id), *args)`` in a new process of
        the rings' context and return it (started). The parent's main
        module is hidden while the process starts, so the client imports
        only ``target``'s module chain, not a script that loads torch."""
        from ..data.workers import _main_module_hidden
        proc = self._ctx.Process(target=target,
                                 args=(self.handle(client_id),) + args,
                                 name=f"serving-client-{client_id}")
        with _main_module_hidden():
            proc.start()
        return proc

    def stop(self) -> None:
        self._stop_flag = True

    def close(self) -> None:
        for ring in self._req_rings + self._resp_rings:
            ring.close()

    def __enter__(self) -> "FrontendServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- the loop
    def _pump_requests(self) -> bool:
        """Drain every live request ring without blocking; True if any."""
        progressed = False
        for cid in range(self.num_clients):
            if not self._alive[cid]:
                continue
            ring = self._req_rings[cid]
            while True:
                try:
                    msg = ring.pop(timeout=0)
                except _queue.Empty:
                    break
                progressed = True
                if msg[0] == "bye":
                    self._alive[cid] = False
                    break
                if self.first_request_t is None:
                    self.first_request_t = time.perf_counter()
                _, req_id, slot, n = msg[:4]
                trace_id = msg[4] if len(msg) > 4 else None
                # Copy out and recycle the slot immediately: the engine may
                # hold the rows well past this slab's next reuse.
                _, slab_ids, slab_vals = ring.arrays(slot, n)
                ids, vals = slab_ids.copy(), slab_vals.copy()
                ring.release(slot)
                try:
                    if self._affinity:
                        fut = self._engine.submit(ids, vals, affinity=cid,
                                                  trace_id=trace_id)
                    else:
                        fut = self._engine.submit(ids, vals,
                                                  trace_id=trace_id)
                except (ServerOverloaded, AdmissionShed, ValueError) as e:
                    self._send_error(cid, req_id, e)
                    continue
                self._inflight.append((fut, cid, req_id))
        return progressed

    def _send_error(self, cid: int, req_id: int, exc: Exception) -> None:
        self._resp_rings[cid].send(
            ("err", req_id, type(exc).__name__, str(exc)))
        self.errors_sent += 1

    def _client_gone(self, cid: int) -> bool:
        return (self._client_alive is not None
                and not self._client_alive(cid))

    def _respond(self) -> bool:
        """Ship every resolved future at the head of the line; True if any.

        Responses are sent head-first per submission order, but a resolved
        future behind an unresolved one does not wait (scan, not strict
        FIFO) — the engine resolves whole flushes at once, so scanning a
        bounded window is cheap.
        """
        progressed = False
        for _ in range(len(self._inflight)):
            fut, cid, req_id = self._inflight.popleft()
            if not fut.done():
                if self._request_timeout_s > 0 and (
                        time.monotonic() - fut.t_enqueue
                        > self._request_timeout_s):
                    # Budget blown: answer NOW with a typed timeout and
                    # cancel the engine leg (dropped at batch formation if
                    # still queued; a mid-flush resolution is ignored).
                    cancel = getattr(fut, "cancel", None)
                    if callable(cancel):
                        cancel()
                    self._send_error(cid, req_id, ServeTimeout(
                        f"request of {getattr(fut, 'n', '?')} rows exceeded "
                        f"the {self._request_timeout_s}s response budget"))
                    self.timeouts_sent += 1
                    progressed = True
                    continue
                self._inflight.append((fut, cid, req_id))
                continue
            if not self._alive[cid] and self._client_gone(cid):
                self.dropped_dead_client += 1
                progressed = True
                continue
            try:
                probs = fut.result(timeout=0)
            except Exception as e:  # noqa: BLE001 — forwarded to the client
                self._send_error(cid, req_id, e)
                progressed = True
                continue
            ring = self._resp_rings[cid]
            # A full response ring blocks here WITHOUT beating the watchdog:
            # a live-but-stuck reader wedging the loop is exactly what the
            # exit-43 contract exists to surface.
            slot = ring.acquire(timeout=self._poll)
            while slot is None and not self._stop_flag:
                if self._client_gone(cid):
                    # Died without a farewell: drop its responses, retire it
                    # so its ring never blocks the loop again.
                    self._alive[cid] = False
                    self.dropped_dead_client += 1
                    slot = -1
                    break
                slot = ring.acquire(timeout=self._poll)
            if slot is None:       # stop() while blocked: abandon the write
                return progressed
            if slot == -1:
                progressed = True
                continue
            n = len(probs)
            slab_probs, _, _ = ring.arrays(slot, n)
            slab_probs[:] = probs
            ring.send(("resp", req_id, slot, n))
            self.responses_sent += 1
            self.last_response_t = time.perf_counter()
            progressed = True
        return progressed

    def serve(self) -> None:
        """Run until every client said ``bye`` and nothing is owed (or
        :meth:`stop`). A stall past ``timeout_s`` with work pending aborts
        with the exit-43 contract (``StallWatchdog`` default abort)."""
        watchdog = None
        if self._timeout_s > 0:
            # Here, not at module top: train.guard imports torch, which a
            # spawned client importing this module must not pay for.
            from ..train.guard import StallWatchdog
            watchdog = StallWatchdog(
                self._timeout_s, name="serving-frontend",
                abort=self._abort).start()
        try:
            while not self._stop_flag:
                progressed = self._pump_requests()
                progressed |= self._respond()
                idle = not self._inflight
                if watchdog is not None and (progressed or idle):
                    watchdog.beat(self.responses_sent)
                if not any(self._alive) and not self._inflight:
                    return
                if not progressed:
                    time.sleep(self._poll)
        finally:
            if watchdog is not None:
                watchdog.stop()
