"""Hot/cold tiered embedding storage on one device (port of
``deepfm_tpu.data.hot_cold``): a device-resident hot-row cache over a
host-RAM cold store, planned ahead of the fit loop.

The embedding tables and their lazy-Adam m/v/tau slots live on the host;
only ``--embedding_hot_rows`` rows of each are on the device. The fit
loop plans each dispatch group ``transfer_ahead`` groups early on its
staging thread (``data.pipeline.prefetch``): look up which ids are already
hot, pick LRU victims for the misses, FETCH the missing rows from the cold
store (the host gather/dequant for dispatch t+1 runs while the device
computes dispatch t), and remap the group's ``feat_ids`` from global ids to
hot SLOT ids. The fit thread then applies the queued plan (evicted-row
write-back, then the fetched rows' install) right before its dispatch. The
staging thread does numpy work only: every transfer and every CUDA call
stays on the fit thread.

Correctness hinges on three orderings, all enforced here:

* Plans are FIFO: ``apply_next`` consumes them in the exact order
  ``plan_group`` queued them, which is the dispatch order.
* A row evicted by a still-pending plan cannot be re-fetched from the cold
  store early (its write-back hasn't happened) -- those rows are marked
  late-fetch and read at apply time, after the pending write-back.
* Slots referenced by any not-yet-applied plan are pinned (refcounted) and
  never chosen as victims; if a group's working set cannot fit in the
  unpinned slots the runtime raises instead of silently corrupting.

The device step is unchanged: staged ``feat_ids`` are slot ids into tables
of ``hot_rows`` rows. The JAX package relies on immutable arrays to keep
installs for dispatch t+1 away from the already-enqueued dispatch t. Here
the hot tables are written IN PLACE, and the order comes from the stream:
the eviction write-back (a blocking device-to-host copy), the install (one
``embedding_kernels.install_rows_tables`` call for every table, one
``dfm_install`` launch on the card) and the step are all enqueued on the
fit thread's current stream. A transaction's values cross to the device in ONE
``non_blocking`` copy out of one pinned buffer from torch's caching host
allocator, which keeps the buffer until the copy has run.

Optional quantized cold storage quarters the host bytes of the weight
tables with a scale-per-row dequant on fetch / requant on write-back:
``--embedding_cold_dtype int8`` (fixed-step symmetric) or ``fp8_e4m3``
(float8, scale = row-max/448). fp8 rounds through torch's
``float8_e4m3fn`` cast on CPU tensors (bit-equal to ``ml_dtypes``, which
the port does not use); the quantized bytes are kept as uint8. The m/v
moment slots stay float32.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..obs import trace as trace_lib
from ..ops import embedding_kernels as ek
from ..utils import faults

log = logging.getLogger(__name__)

#: Largest finite float8 e4m3fn value (``torch.finfo(torch.float8_e4m3fn)``).
_FP8_MAX = 448.0

# __init__ quantizes the adopted table through write() in chunks of this
# many rows, so the write scratch stays bounded instead of growing to a
# full-vocab float32 temp.
_INIT_WRITE_CHUNK = 8192


def _pow2_pad(n: int) -> int:
    """Smallest power of two >= n (>= 1): keeps install sizes on an
    O(log max_group) ladder."""
    p = 1
    while p < n:
        p *= 2
    return p


def _fp8_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> float8 e4m3fn (round to nearest even), as uint8 bits."""
    return torch.from_numpy(x).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy()


class ColdStore:
    """Host-RAM row store for ONE table: float32, or a quantized tier with
    a per-row float32 scale -- ``int8`` (row-max/127 symmetric, rint) or
    ``fp8_e4m3`` (row-max/448, cast-rounded; kept as uint8 bits).

    fetch()/write() run on every cache transaction, so both work out of
    per-store scratch buffers: ``fetch`` returns a VIEW into the scratch,
    valid until the next fetch on this store -- callers copy out (every
    runtime call site assigns into its own array immediately)."""

    def __init__(self, array: np.ndarray, dtype: str):
        a = np.asarray(array, np.float32)
        self.shape = a.shape
        self.dtype = dtype
        self._trail = tuple(range(1, a.ndim))
        self._fetch_f32: Optional[np.ndarray] = None  # fetch dequant out
        self._fetch_q: Optional[np.ndarray] = None    # fetch raw-row stage
        self._write_f32: Optional[np.ndarray] = None  # write quant stage
        if dtype in ("int8", "fp8_e4m3"):
            if dtype == "fp8_e4m3":
                self._qdt, self._qmax = np.dtype(np.uint8), _FP8_MAX
            else:
                self._qdt, self._qmax = np.dtype(np.int8), 127.0
            self._scale = np.empty(a.shape[:1], np.float32)
            self._q = np.empty(a.shape, self._qdt)
            for lo in range(0, a.shape[0], _INIT_WRITE_CHUNK):
                hi = min(lo + _INIT_WRITE_CHUNK, a.shape[0])
                self.write(np.arange(lo, hi), a[lo:hi])
        elif dtype == "float32":
            self._data = a.copy()
        else:
            raise ValueError(f"unknown cold dtype {dtype!r}")

    def nbytes(self) -> int:
        if self.dtype != "float32":
            return self._q.nbytes + self._scale.nbytes
        return self._data.nbytes

    def _scratch(self, which: str, n: int) -> np.ndarray:
        """First-n-rows view of the named scratch buffer, growing it to the
        next power of two when the request outsizes it."""
        buf = getattr(self, which)
        if buf is None or buf.shape[0] < n:
            dt = self._qdt if which == "_fetch_q" else np.float32
            buf = np.empty((_pow2_pad(n),) + self.shape[1:], dt)
            setattr(self, which, buf)
        return buf[:n]

    def _dequant(self, q: np.ndarray, out: np.ndarray) -> None:
        if self.dtype == "fp8_e4m3":
            torch.from_numpy(out).copy_(
                torch.from_numpy(q).view(torch.float8_e4m3fn))
        else:
            np.copyto(out, q, casting="unsafe")

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """float32 rows at ``ids`` (dequantized for the quantized tiers),
        as a reused-scratch VIEW (see class docstring). The fault seam
        fires here -- callers retry via :class:`TieredEmbeddingRuntime`."""
        faults.check_cold_fetch()
        ids = np.asarray(ids, np.int64)
        out = self._scratch("_fetch_f32", ids.size)
        if self.dtype != "float32":
            q = self._scratch("_fetch_q", ids.size)
            np.take(self._q, ids, axis=0, out=q)
            self._dequant(q, out)
            out *= self._scale[ids].reshape((-1,) + (1,) * len(self._trail))
        else:
            np.take(self._data, ids, axis=0, out=out)
        return out

    def write(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows, np.float32)
        if self.dtype == "float32":
            self._data[ids] = rows
            return
        w = self._scratch("_write_f32", ids.size)
        np.abs(rows, out=w)
        amax = w.max(axis=self._trail) if self._trail else w.copy()
        scale = np.maximum(amax, 1e-12, out=amax)
        scale /= self._qmax
        self._scale[ids] = scale
        np.divide(rows, scale.reshape((-1,) + (1,) * len(self._trail)),
                  out=w)
        if self.dtype == "int8":
            np.rint(w, out=w)  # fp8 rounds in the cast; int8 truncates
        np.clip(w, -self._qmax, self._qmax, out=w)
        if self.dtype == "fp8_e4m3":
            self._q[ids] = _fp8_bits(w)
        else:
            self._q[ids] = w  # casts on assignment, no full-size temp

    def dense(self) -> np.ndarray:
        """The whole table as float32 (eval/export densification)."""
        if self.dtype == "float32":
            return self._data.copy()
        out = np.empty(self.shape, np.float32)
        self._dequant(self._q, out)
        return out * self._scale.reshape((-1,) + (1,) * len(self._trail))


class _InstallPlan:
    """One dispatch group's queued cache transaction (built on the staging
    thread, applied on the fit thread in FIFO order)."""

    __slots__ = ("evict_slots", "evict_ids", "install_slots", "install_ids",
                 "late_idx", "values", "group_slots")

    def __init__(self):
        self.evict_slots: np.ndarray = np.zeros((0,), np.int32)
        self.evict_ids: np.ndarray = np.zeros((0,), np.int32)
        self.install_slots: np.ndarray = np.zeros((0,), np.int32)
        self.install_ids: np.ndarray = np.zeros((0,), np.int32)
        self.late_idx: np.ndarray = np.zeros((0,), np.int64)
        # name -> {"w","m","v","tau"} arrays [I, ...] (late rows filled at
        # apply time, after the pending eviction's write-back).
        self.values: Dict[str, Dict[str, np.ndarray]] = {}
        self.group_slots: np.ndarray = np.zeros((0,), np.int32)


class TieredEmbeddingRuntime:
    """Owns the id->slot directory, the per-param cold stores, and the
    plan/apply protocol described in the module docstring."""

    def __init__(self, cfg: Config, model: Any):
        if cfg.embedding_bucket_sizes:
            raise ValueError("hot/cold tiering supports the monolithic "
                             "table layout only")
        self.cfg = cfg
        self.model = model
        self.names: Tuple[str, ...] = tuple(model.embedding_param_names())
        self._key = model.emb.MONO  # the table's key in the optimizer state
        self.hot_rows = int(cfg.embedding_hot_rows)
        self.feature_size = int(cfg.feature_size)
        # Directory (the staging thread owns mutations after adopt()).
        self.id_to_slot = np.full((self.feature_size,), -1, np.int32)
        self.slot_to_id = np.full((self.hot_rows,), -1, np.int32)
        self.last_used = np.zeros((self.hot_rows,), np.int64)
        self.pin_count = np.zeros((self.hot_rows,), np.int32)
        self.clock = 0
        self._free: List[int] = list(range(self.hot_rows - 1, -1, -1))
        self._pending: "collections.deque[_InstallPlan]" = collections.deque()
        self._pending_evicted: Dict[int, int] = {}  # id -> pending count
        self._lock = threading.Lock()
        # Signaled by apply_next when it releases a plan's slot pins, and by
        # stop_staging; the staging thread waits on it when the lookahead
        # has pinned too much of the cache for the next group to fit.
        self._cond = threading.Condition(self._lock)
        # Staging generation: a fit's plan_group calls carry the value
        # start_staging gave it, and stop to plan once stop_staging moves
        # it on (so a staging thread outliving its fit changes nothing).
        self._generation = 0
        self.cold: Dict[str, ColdStore] = {}
        self.cold_m: Dict[str, np.ndarray] = {}
        self.cold_v: Dict[str, np.ndarray] = {}
        self.cold_tau: Dict[str, np.ndarray] = {}
        self.stats: Dict[str, float] = {
            "lookups": 0, "hits": 0, "misses": 0, "evictions": 0,
            "installs": 0, "plans": 0, "fetch_retries": 0,
            "prefetch_fetch_s": 0.0,   # cold fetches on the staging thread
            "apply_fetch_s": 0.0,      # late fetches on the fit thread
            "apply_s": 0.0,            # total fit-thread apply time
        }
        self._adopted = False

    # -- state adoption -------------------------------------------------
    def adopt(self, state):
        """Move the full tables (and their lazy-Adam slots) to the cold
        store; returns a state whose embedding params and slots are
        ``hot_rows``-row zero tables on the same device (leaves that
        require grad, as ``Trainer.init_state`` makes them). Called once,
        by ``Trainer.init_state`` or after a restore into the dense
        template."""
        if self._adopted:
            raise RuntimeError("TieredEmbeddingRuntime.adopt called twice")
        from ..train import optimizers as opt_lib  # noqa: PLC0415
        params = dict(state.params)
        embed = dict(state.opt_state["embed"])
        for name in self.names:
            table = params[name]
            full = table.detach().float().cpu().numpy()
            real = full[: self.feature_size]  # pad rows are zero; drop them
            self.cold[name] = ColdStore(real, self.cfg.embedding_cold_dtype)
            # Seed the cold moment slots from the state being adopted: zeros
            # for a fresh init, the restored Adam moments when the state
            # came from a densified checkpoint (the dense->tiered restore
            # direction is then bit-exact).
            entry = embed[name][self._key]
            fs = self.feature_size
            self.cold_m[name] = entry.m.cpu().numpy()[:fs].copy()
            self.cold_v[name] = entry.v.cpu().numpy()[:fs].copy()
            self.cold_tau[name] = entry.tau.cpu().numpy()[:fs].copy()
            hot_shape = (self.hot_rows,) + real.shape[1:]
            dev = table.device
            params[name] = torch.zeros(hot_shape, dtype=torch.float32,
                                       device=dev).requires_grad_()
            embed[name] = {self._key: opt_lib.EmbedAdamEntry(
                m=torch.zeros(hot_shape, dtype=torch.float32, device=dev),
                v=torch.zeros(hot_shape, dtype=torch.float32, device=dev),
                tau=torch.zeros((self.hot_rows,), dtype=torch.int32,
                                device=dev))}
            log.info("hot/cold: %s cold=%.1f MiB host (%s), hot=%d rows "
                     "device-resident", name,
                     self.cold[name].nbytes() / 2 ** 20,
                     self.cfg.embedding_cold_dtype, self.hot_rows)
        self._adopted = True
        return dataclasses.replace(
            state, params=params, opt_state={**state.opt_state,
                                             "embed": embed})

    # -- staging-thread side --------------------------------------------
    def start_staging(self) -> int:
        """A fresh staging generation for one fit (see ``plan_group``)."""
        with self._lock:
            self._generation += 1
            return self._generation

    def stop_staging(self, state) -> None:
        """End a fit's staging: no plan_group call of its generation plans
        again (one waiting on pins wakes and raises), then every plan
        already queued is applied to ``state`` -- an abandoned fit leaves
        the directory and the hot tables consistent, with no pins held."""
        with self._cond:
            self._generation += 1
            self._cond.notify_all()
        while self._pending:
            self.apply_next(state)

    def _fetch(self, store: ColdStore, ids: np.ndarray) -> np.ndarray:
        """Cold fetch with bounded retry healing of injected/transient
        faults."""
        attempts = 3
        for i in range(attempts):
            try:
                return store.fetch(ids)
            except faults.InjectedFault as exc:
                if i == attempts - 1:
                    raise
                self.stats["fetch_retries"] += 1
                log.warning("cold fetch failed (%s); retrying", exc)

    def plan_group(self, group: List[Dict[str, np.ndarray]], *,
                   generation: Optional[int] = None
                   ) -> List[Dict[str, np.ndarray]]:
        """Plan one dispatch group's cache transaction and remap its
        ``feat_ids`` to hot slot ids. Runs on the staging thread; the cold
        fetches issued here are the prefetch that overlaps device compute.
        ``generation`` (from :meth:`start_staging`) makes the call raise
        once that fit has stopped staging."""
        with trace_lib.span("hotcold.plan"), self._lock:
            self._check_generation(generation)
            return self._plan_group_locked(group, generation)

    def _check_generation(self, generation: Optional[int]) -> None:
        if generation is not None and generation != self._generation:
            raise RuntimeError("hot/cold staging stopped: its fit ended")

    def _plan_group_locked(self, group, generation):
        self.clock += 1
        self.stats["plans"] += 1
        flat = np.concatenate([b["feat_ids"].ravel() for b in group])
        uids = np.unique(flat.astype(np.int64))
        if uids.size and (uids[0] < 0 or uids[-1] >= self.feature_size):
            raise ValueError("feat_ids outside [0, feature_size) under "
                             "hot/cold tiering")
        self.stats["lookups"] += int(uids.size)
        plan = _InstallPlan()
        slots = self.id_to_slot[uids]
        resident = slots >= 0
        self.stats["hits"] += int(resident.sum())
        missing = uids[~resident]
        self.stats["misses"] += int(missing.size)
        # Refresh everything this group touches BEFORE victim selection so
        # the group can never evict its own working set.
        self.last_used[slots[resident]] = self.clock
        if missing.size:
            new_slots = np.empty((missing.size,), np.int32)

            def evictable():
                # Unpinned resident slots, excluding the rows this very
                # group just refreshed. Only this (staging) thread mutates
                # residency/last_used; apply_next only releases pins.
                cand = np.flatnonzero(
                    (self.pin_count == 0) & (self.slot_to_id >= 0))
                return cand[self.last_used[cand] < self.clock]

            # The lookahead pins every pending group's working set; if the
            # next group doesn't fit in what's left, wait for the fit
            # thread to apply a plan and release its pins. Only when no
            # pins are outstanding is the cache GENUINELY too small.
            while len(self._free) + evictable().size < missing.size:
                if not self._pending and int(self.pin_count.sum()) == 0:
                    raise RuntimeError(
                        f"hot cache too small: group needs {missing.size} "
                        f"installs but only {len(self._free)} free + "
                        f"{evictable().size} evictable slots "
                        f"(embedding_hot_rows={self.hot_rows}; raise it "
                        f"above one dispatch group's unique-id working set)")
                if not self._cond.wait(timeout=120.0):
                    raise RuntimeError(
                        "hot/cold tiering stalled waiting for slot pins to "
                        "release (fit loop not applying plans?)")
                self._check_generation(generation)
            # Free slots in the order list.pop() hands them out.
            n_free = min(len(self._free), missing.size)
            if n_free:
                new_slots[:n_free] = self._free[:-n_free - 1:-1]
                del self._free[-n_free:]
            need = missing.size - n_free
            victims = np.zeros((0,), np.int64)
            vids = np.zeros((0,), np.int32)
            if need > 0:
                cand = evictable()
                victims = cand[np.argsort(
                    self.last_used[cand], kind="stable")][:need]
                vids = self.slot_to_id[victims]
                self.id_to_slot[vids] = -1
                for vid in vids.tolist():
                    self._pending_evicted[vid] = \
                        self._pending_evicted.get(vid, 0) + 1
                new_slots[n_free:] = victims
            self.stats["evictions"] += int(victims.size)
            self.stats["installs"] += int(missing.size)
            self.id_to_slot[missing] = new_slots
            self.slot_to_id[new_slots] = missing
            self.last_used[new_slots] = self.clock
            plan.evict_slots = victims.astype(np.int32)
            plan.evict_ids = vids.astype(np.int32)
            plan.install_slots = new_slots
            plan.install_ids = missing.astype(np.int32)
            # Rows whose write-back is still pending must be fetched at
            # apply time (their cold copy is stale until then). Evicted and
            # installed ids are disjoint within one plan (resident vs not),
            # so any pending entry here is from an OLDER plan.
            late = np.zeros((0,), np.int64)
            if self._pending_evicted:
                pend = np.fromiter(self._pending_evicted, np.int64,
                                   len(self._pending_evicted))
                late = np.flatnonzero(np.isin(missing, pend))
            plan.late_idx = late
            early = np.setdiff1d(np.arange(missing.size), late)
            t0 = time.time()
            for name in self.names:
                trail = self.cold[name].shape[1:]
                vals = {
                    "w": np.zeros((missing.size,) + trail, np.float32),
                    "m": np.zeros((missing.size,) + trail, np.float32),
                    "v": np.zeros((missing.size,) + trail, np.float32),
                    "tau": np.zeros((missing.size,), np.int32),
                }
                if early.size:
                    eids = missing[early]
                    vals["w"][early] = self._fetch(self.cold[name], eids)
                    vals["m"][early] = self.cold_m[name][eids]
                    vals["v"][early] = self.cold_v[name][eids]
                    vals["tau"][early] = self.cold_tau[name][eids]
                plan.values[name] = vals
            self.stats["prefetch_fetch_s"] += time.time() - t0
        # Pin every slot the group references until its plan is applied.
        group_slots = self.id_to_slot[uids]
        self.pin_count[group_slots] += 1
        plan.group_slots = group_slots.astype(np.int32)
        self._pending.append(plan)
        # Remap the group's ids to slot ids (the arrays staged to device).
        out = []
        for b in group:
            nb = dict(b)
            nb["feat_ids"] = self.id_to_slot[
                b["feat_ids"].astype(np.int64)].astype(np.int32)
            out.append(nb)
        return out

    # -- fit-thread side ------------------------------------------------
    def _pad_slots(self, slots: np.ndarray) -> np.ndarray:
        """Slot list padded to the next power of two with the out-of-range
        slot id ``hot_rows`` (dropped by the install), so install sizes stay
        on an O(log max_group) ladder."""
        p = _pow2_pad(max(slots.size, 1))
        ps = np.full((p,), self.hot_rows, np.int32)
        ps[: slots.size] = slots
        return ps

    def _width(self, name: str) -> int:
        return int(np.prod(self.cold[name].shape[1:], dtype=np.int64))

    def _read_rows(self, state, name: str, slots: np.ndarray):
        """(w, m, v, tau) numpy rows of table ``name`` at hot ``slots``,
        through ONE blocking device-to-host copy on the current stream, so
        it reads what every step enqueued before it wrote."""
        table = state.params[name]
        oe = state.opt_state["embed"][name][self._key]
        idx = torch.from_numpy(slots.astype(np.int64)).to(table.device)
        n, d = idx.numel(), self._width(name)
        cols = [t.detach()[idx].reshape(n, d).view(torch.int32)
                for t in (table, oe.m, oe.v)]
        packed = torch.cat(cols + [oe.tau[idx].reshape(n, 1)], 1).cpu()
        packed = packed.numpy()
        trail = self.cold[name].shape[1:]
        w, m, v = (np.ascontiguousarray(packed[:, i * d:(i + 1) * d]).view(
            np.float32).reshape((n,) + trail) for i in range(3))
        return w, m, v, np.ascontiguousarray(packed[:, 3 * d])

    def _stage_values(self, plan: _InstallPlan, device: torch.device):
        """The transaction's padded slots and every table's padded values,
        packed as int32 words into ONE host buffer (pinned, from torch's
        caching host allocator, on the card) and moved to ``device`` in one
        copy. Returns (slots [P], {name: (wv, mv, vv, tv)}) on ``device``."""
        s = plan.install_slots
        n, ps = s.size, self._pad_slots(s)
        p = ps.size
        widths = {name: self._width(name) for name in self.names}
        total = p + sum(p * (3 * d + 1) for d in widths.values())
        cuda = device.type == "cuda"
        host = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        buf = host.numpy()
        buf[:p] = ps
        off = p
        for name in self.names:
            d, vals = widths[name], plan.values[name]
            for key in ("w", "m", "v"):
                buf[off:off + n * d].view(np.float32)[:] = \
                    vals[key].reshape(-1)
                off += p * d
            buf[off:off + n] = vals["tau"]
            off += p
        dev = host.to(device, non_blocking=True) if cuda else host
        out = {}
        off = p
        for name in self.names:
            d = widths[name]
            trail = self.cold[name].shape[1:]
            arrs = []
            for _ in range(3):
                arrs.append(dev[off:off + p * d].view(torch.float32)
                            .reshape((p,) + trail))
                off += p * d
            arrs.append(dev[off:off + p])
            off += p
            out[name] = tuple(arrs)
        return dev[:p], out

    def apply_next(self, state):
        """Apply the oldest queued plan to ``state`` in place: write evicted
        rows back to the cold store (reading the values every earlier step
        left), late-fetch any rows whose cold copy only just became
        current, then install the fetched rows (weights + m/v/tau) into
        their hot slots. Returns ``state``."""
        if not self._pending:
            return state
        with trace_lib.span("hotcold.install"):
            self._apply_next_traced(state)
        return state

    def _write_back(self, state, plan: _InstallPlan) -> None:
        """The evicted rows (weights + moments) back to the cold store, and
        their pending-eviction marks released."""
        ids = plan.evict_ids
        for name in self.names:
            w, m, v, tau = self._read_rows(state, name, plan.evict_slots)
            self.cold[name].write(ids, w)
            self.cold_m[name][ids] = m
            self.cold_v[name][ids] = v
            self.cold_tau[name][ids] = tau
        with self._lock:
            for vid in ids.tolist():
                left = self._pending_evicted.get(vid, 0) - 1
                if left <= 0:
                    self._pending_evicted.pop(vid, None)
                else:
                    self._pending_evicted[vid] = left

    def _apply_next_traced(self, state) -> None:
        t_apply = time.time()
        plan = self._pending.popleft()
        if plan.evict_slots.size:
            with trace_lib.span("hotcold.writeback"):
                self._write_back(state, plan)
        if plan.late_idx.size:
            # Under the lock: the staging thread fetches from the same
            # stores (and their scratch buffers) while it plans.
            with self._lock:
                t0 = time.time()
                lids = plan.install_ids[plan.late_idx].astype(np.int64)
                for name in self.names:
                    vals = plan.values[name]
                    vals["w"][plan.late_idx] = self._fetch(self.cold[name],
                                                           lids)
                    vals["m"][plan.late_idx] = self.cold_m[name][lids]
                    vals["v"][plan.late_idx] = self.cold_v[name][lids]
                    vals["tau"][plan.late_idx] = self.cold_tau[name][lids]
                self.stats["apply_fetch_s"] += time.time() - t0
        if plan.install_slots.size:
            device = state.params[self.names[0]].device
            with trace_lib.span("hotcold.stage"):
                slots, values = self._stage_values(plan, device)
            embed = state.opt_state["embed"]
            # ONE launch per transaction: every table's weight rows and
            # all three lazy-Adam companions install together.
            tables = [(state.params[name], embed[name][self._key].m,
                       embed[name][self._key].v, embed[name][self._key].tau)
                      for name in self.names]
            ek.install_rows_tables(tables, slots,
                                   [values[name] for name in self.names],
                                   mode=self.cfg.embedding_kernels)
        with self._cond:
            self.pin_count[plan.group_slots] -= 1
            self._cond.notify_all()
        self.stats["apply_s"] += time.time() - t_apply

    # -- eval / export --------------------------------------------------
    def _held(self) -> Tuple[np.ndarray, np.ndarray]:
        """(slots, ids): the hot slots that hold a row now and whose row.
        That is the directory with the still-queued plans rolled back: a
        queued plan has already remapped its slots, but its write-back and
        install have not run, so its victims' rows are still in place."""
        with self._lock:
            held = self.slot_to_id.copy()
            for plan in reversed(self._pending):
                held[plan.install_slots] = -1
                held[plan.evict_slots] = plan.evict_ids
        slots = np.flatnonzero(held >= 0)
        return slots, held[slots].astype(np.int64)

    def flush(self, state) -> None:
        """Write every row the hot tables hold (weights + moments) back to
        the cold store. Leaves residency unchanged (the hot copy stays the
        authoritative one for training). Safe in the middle of a fit with
        plans queued (a checkpoint hook)."""
        res, ids = self._held()
        if not res.size:
            return
        for name in self.names:
            w, m, v, tau = self._read_rows(state, name, res)
            self.cold[name].write(ids, w)
            self.cold_m[name][ids] = m
            self.cold_v[name][ids] = v
            self.cold_tau[name][ids] = tau

    def _full(self, real: np.ndarray, dtype, device) -> torch.Tensor:
        """``real`` [feature_size, ...] padded with zero rows to the
        model's ``padded_vocab``, as a tensor on ``device``."""
        full = np.zeros((self.model.emb.padded_vocab,) + real.shape[1:],
                        dtype)
        full[: self.feature_size] = real
        return torch.from_numpy(full).to(device)

    def densified(self, state):
        """A state whose embedding params are the FULL ``[padded_vocab,
        ...]`` float32 tables (flushed hot rows + cold rows + zero pad
        rows), sharing every other tensor with ``state``: the offline
        eval/predict/export path runs the ordinary dense forward on it."""
        self.flush(state)
        params = dict(state.params)
        for name in self.names:
            params[name] = self._full(self.cold[name].dense(), np.float32,
                                      params[name].device)
        return dataclasses.replace(state, params=params)

    def checkpoint_state(self, state):
        """The state an UNTIERED run would checkpoint: full densified
        params PLUS full-shape embedding Adam slots (hot window flushed
        back, cold rows merged, pad rows zero). A checkpoint written from
        this state restores bit-exactly into a dense run, a differently
        sized hot cache, or back into this one (via adopt-after-restore)."""
        from ..train import optimizers as opt_lib  # noqa: PLC0415
        state = self.densified(state)  # flush() inside syncs cold_m/v/tau
        embed = dict(state.opt_state["embed"])
        for name in self.names:
            dev = state.params[name].device
            embed[name] = {self._key: opt_lib.EmbedAdamEntry(
                m=self._full(self.cold_m[name], np.float32, dev),
                v=self._full(self.cold_v[name], np.float32, dev),
                tau=self._full(self.cold_tau[name], np.int32, dev))}
        return dataclasses.replace(
            state, opt_state={**state.opt_state, "embed": embed})

    def hit_rate(self) -> float:
        n = self.stats["lookups"]
        return float(self.stats["hits"] / n) if n else 0.0

    def overlap_fraction(self) -> float:
        """Fraction of total cold-fetch wall time that ran on the staging
        thread (i.e. overlapped device compute instead of stalling the
        dispatch loop)."""
        tot = self.stats["prefetch_fetch_s"] + self.stats["apply_fetch_s"]
        return float(self.stats["prefetch_fetch_s"] / tot) if tot else 1.0
