"""Kernels of the sparse embedding plane, with their plain versions: the
counterpart of ``deepfm_tpu/ops/pallas_embedding.py`` (its plan build, its
gather/segment-sum pair and the hot/cold tier's cache install).

Each seam has up to three legs, picked by :func:`resolve` from the
``--embedding_kernels`` mode as the JAX package picks them:

  * ``kernel`` (``auto``, ``pallas``) -- the hand-written CUDA kernels of
    ``csrc/embedding.cu`` on CUDA tensors. A CPU tensor takes the kernel's
    plain version instead; a CUDA tensor launches the kernel or raises.
  * ``opt`` (``xla``, and under ``auto``/``pallas`` the plans over more
    than ``PLAN_COUNT_MAX_ROWS`` rows) -- the plain torch legs: the
    counting plan build, ``rows[inv]`` with autograd's own backward, and
    the install's four masked copies under one mask
    (``reference_install``).
  * ``ref`` (``off``) -- the sort-based plan, ``rows[inv]``, and one
    masked copy per array (``install_array``, the JAX ``_jit_install``).

The sparse exact Adagrad's seam (``"adagrad"``) is picked here too; its
kernel (``csrc/optimizer.cu``) and its wrapper live in
``train/optimizers.py``, and both plain legs are its foreach path.

Above ``PLAN_COUNT_MAX_ROWS`` rows the JAX package keeps the sort leg;
the port takes the counting plan's plain version there on every layout
(a [rows + 1] prefix sum on the card), since the sort leg's unique count
waits for the card once a table a step. The plans are the same.

All legs give bit-identical plans and installs. The take legs give
identical values; their backward sums each uid slot's cotangents in
ascending batch position from 0.0 on the CPU and in the kernel (the order
of the TPU kernel's loop and of XLA's scatter-add, so the gradient equals
the JAX package's bit for bit), while autograd's ``rows[inv]`` backward on
the card may sum in another order.

The ``opt`` leg (``xla``) is the library yardstick and is order-free on
the card: the monolithic table's fused backward sums through
``index_add_`` (:func:`segment_sum`'s plain version), whose float atomics
may add in another order from run to run, so same-seed runs on that leg
need not repeat bit for bit (``chip_smoke.py``'s determinism phase prints
the diff: table diffs of 1e-9 to 2e-9 on an H100 80GB HBM3 at 700 W). The
``ref`` leg (``off``) sums its take backward through autograd's
``index_put_`` with accumulate, in the library's order. The dense lookups
(:class:`IndexRows`, hashed or not) sum through the take backward on every
leg, so they repeat bit for bit under ``xla`` too.

Every kernel serves up to ``MAX_TABLES`` tables in one launch: a hashed
step builds all its tables' plans with one launch
(:func:`plan_build_tables`), their position segments with one launch
(:func:`position_segments_tables`), and views each embedding name's
tables, masks and table sum with one take forward and one take backward
(:func:`take_rows_sum`); a hot/cold transaction installs both of its
tables with one launch (:func:`install_rows_tables`).

Launch counters are plain ints on this module: ``plan_launches``,
``take_fwd_launches``, ``take_bwd_launches``, ``segments_launches`` and
``install_launches``, each raised by one where its wrapper launches its
kernel. A take backward sums runs of more than ``LONG_RUN`` positions on
a path of their own (``csrc/embedding.cu``); while tracing is on, each
launch's count of such runs and of their positions is added to the open
``embed.bwd`` span's args (``long_runs``, ``long_positions``) and to the
totals ``take_bwd_long_runs`` and ``take_bwd_long_positions``, once the
card has run it (no host sync; nothing is counted with tracing off).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from ..obs import trace as trace_lib
from . import embedding as emb_ops

#: embedding_kernels values (config-validated).
MODES = ("auto", "pallas", "xla", "off")

#: Tables one plan-build, take or install launch serves
#: (``csrc/embedding.cu`` ``kMaxTables``).
MAX_TABLES = 8

#: Runs of more positions than this take the take backward's long-run
#: path (``csrc/embedding.cu`` ``kLongRun``).
LONG_RUN = 256

# The plan kernel counts over a [rows+1] id space; above this many rows
# the counting plan's plain version builds the plan (the JAX package's
# ``pallas_embedding`` keeps its sort-based build there).
PLAN_COUNT_MAX_ROWS = 2_000_000

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()

plan_launches = 0
take_fwd_launches = 0
take_bwd_launches = 0
segments_launches = 0
install_launches = 0
take_bwd_long_runs = 0
take_bwd_long_positions = 0


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def resolve(mode: str, kernel: str, *, num_rows: int = 0) -> str:
    """The leg ("kernel" | "opt" | "ref") of one seam ("plan" | "take" |
    "install" | "adagrad", the last the sparse exact-Adagrad update of
    ``train/optimizers.py``)."""
    if mode not in MODES:
        raise ValueError(f"embedding_kernels must be one of {MODES}, "
                         f"got {mode!r}")
    if kernel not in ("plan", "take", "install", "adagrad"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if mode == "off":
        return "ref"
    if kernel == "plan" and num_rows > PLAN_COUNT_MAX_ROWS:
        return "opt"
    return "kernel" if mode in ("auto", "pallas") else "opt"


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")


# ---------------------------------------------------------------------------
# Plan build (TPU kernel: pallas_embedding.py `_plan_kernel`)
# ---------------------------------------------------------------------------


def _stacked_ids(ids, t: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(ids as int32 [T, N], one table's ids shape), checked."""
    if isinstance(ids, torch.Tensor):
        if ids.dim() < 1 or ids.shape[0] != t:
            raise ValueError(f"plan ids [T, ...] for {t} tables; got "
                             f"{tuple(ids.shape)}")
        parts, shape = [ids], tuple(ids.shape[1:])
    else:
        parts = list(ids)
        if len(parts) != t:
            raise ValueError(f"{len(parts)} id tensors for {t} tables")
        shape = tuple(parts[0].shape)
        if any(p.numel() != parts[0].numel() for p in parts):
            raise ValueError(f"plan ids of one size N per table; got "
                             f"{[tuple(p.shape) for p in parts]}")
    for p in parts:
        _check_device(p, "plan build")
        if p.dtype.is_floating_point or p.dtype.is_complex \
                or p.dtype == torch.bool:
            raise TypeError(f"plan ids must be integers, got {p.dtype}")
        if p.device != parts[0].device:
            raise ValueError("plan ids lie on different devices")
    if len(parts) == 1:
        flat = parts[0].reshape(t, -1)
    else:
        flat = torch.stack([p.reshape(-1) for p in parts])
    return flat.to(torch.int32).contiguous(), shape


def _launch_plan(ids: torch.Tensor, shape: Tuple[int, ...],
                 rows: List[int], masks) -> List[emb_ops.PlanEntry]:
    """One ``dfm_plan_build`` launch for every table: the outputs are
    allocated once, stacked, and each table's entry holds views of them."""
    t, n = ids.shape
    dev = ids.device
    uids = torch.empty((t, n), dtype=torch.int32, device=dev)
    inv = torch.empty((t, n), dtype=torch.int32, device=dev)
    touched = torch.empty(sum(rows), dtype=torch.bool, device=dev)
    rank = torch.empty(sum(rows), dtype=torch.int32, device=dev)
    lib = _native.load("embedding")
    with torch.cuda.device(dev):
        err = lib.dfm_plan_build(
            ids.data_ptr(), uids.data_ptr(), inv.data_ptr(),
            touched.data_ptr(), rank.data_ptr(), (ctypes.c_int64 * t)(*rows),
            t, n, _stream(dev))
    _native.check(err, "plan build")
    _count("plan_launches")
    out, off = [], 0
    for i, r in enumerate(rows):
        out.append(emb_ops.PlanEntry(
            uids=uids[i], inv=inv[i].reshape(shape), mask=masks[i],
            num_rows=r, touched=touched[off:off + r], rank=rank[off:off + r]))
        off += r
    return out


def plan_build_tables(ids, rows: Sequence[int],
                      masks: Optional[Sequence[Optional[torch.Tensor]]] = None
                      ) -> List[emb_ops.PlanEntry]:
    """Counting plans with touched/rank for 1 to ``MAX_TABLES`` tables:
    one ``dfm_plan_build`` launch for all of them on CUDA tensors, the
    plain version ``make_plan_counting`` per table on CPU tensors.

    ``ids``: T id tensors of one size N, or one ``[T, ...]`` tensor (row t
    holds table t's ids, so a caller that builds them stacked spares the
    copy); ``rows``: each table's row count, its fill id; ``masks``: each
    entry's ``mask``. Every plan equals ``make_plan_counting``'s bit for
    bit (uids, inv, touched; rank under touched)."""
    rows = [int(r) for r in rows]
    t = len(rows)
    if not 1 <= t <= MAX_TABLES:
        raise ValueError(f"a plan launch serves 1 to {MAX_TABLES} tables, "
                         f"got {t}")
    if any(r < 1 for r in rows):
        raise ValueError(f"plan tables need at least one row, got {rows}")
    masks = [None] * t if masks is None else list(masks)
    if len(masks) != t:
        raise ValueError(f"{len(masks)} masks for {t} tables")
    flat, shape = _stacked_ids(ids, t)
    if flat.device.type == "cpu":
        return [emb_ops.make_plan_counting(flat[i].reshape(shape), r, m)
                for i, (r, m) in enumerate(zip(rows, masks))]
    return _launch_plan(flat, shape, rows, masks)


def plan_build_kernel(ids: torch.Tensor, num_rows: int,
                      mask: Optional[torch.Tensor] = None
                      ) -> emb_ops.PlanEntry:
    """One table's counting plan with touched/rank through
    :func:`plan_build_tables`."""
    return plan_build_tables([ids], [num_rows], [mask])[0]


def plan_build(ids: torch.Tensor, num_rows: int,
               mask: Optional[torch.Tensor] = None, *,
               mode: str = "auto") -> emb_ops.PlanEntry:
    """A sparse-update plan through the selected leg. Every leg gives
    bit-identical uids/inv; the counting legs add touched/rank."""
    leg = resolve(mode, "plan", num_rows=num_rows)
    if leg == "kernel":
        return plan_build_kernel(ids, num_rows, mask)
    if leg == "opt":
        return emb_ops.make_plan_counting(ids, num_rows, mask)
    return emb_ops.make_plan(ids, num_rows, mask)


def reference_plan_numpy(ids, num_rows):
    """np.unique-based oracle for the plan builders (tests):
    (uids, inv, touched, rank), rank zero where untouched."""
    flat = np.asarray(ids).reshape(-1).astype(np.int64)
    uniq, inv = np.unique(flat, return_inverse=True)
    n = flat.size
    uids = np.full((n,), num_rows, np.int32)
    uids[: uniq.size] = uniq
    real = uniq < num_rows
    touched = np.zeros((num_rows,), bool)
    touched[uniq[real]] = True
    rank = np.zeros((num_rows,), np.int32)
    rank[uniq[real]] = np.arange(uniq.size)[real]
    return (uids, inv.reshape(np.asarray(ids).shape).astype(np.int32),
            touched, rank)


# ---------------------------------------------------------------------------
# Take: gather forward + position-order segment-sum backward
# (TPU kernels: pallas_embedding.py `_take_fwd_kernel`, `_take_bwd_kernel`)
# ---------------------------------------------------------------------------


Segments = Tuple[torch.Tensor, torch.Tensor]


def _segment_keys(inv: torch.Tensor, num_slots: int,
                  keep: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 keys: inv where it lies in [0, num_slots) and ``keep`` holds,
    else ``num_slots`` (the left-out run after every slot's)."""
    ok = (inv >= 0) & (inv < num_slots)
    if keep is not None:
        ok = ok & keep
    return torch.where(ok, inv, torch.full((), num_slots, dtype=inv.dtype,
                                           device=inv.device)
                       ).to(torch.int32)


def reference_position_segments(inv: torch.Tensor, num_slots: int,
                                keep: Optional[torch.Tensor] = None
                                ) -> Segments:
    """The segments kernel's plain version: one stable sort of the keys and
    one ``searchsorted`` of the slots' bounds (see
    :func:`position_segments`)."""
    keys = _segment_keys(inv.reshape(-1), num_slots,
                         None if keep is None else keep.reshape(-1))
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_slots + 1, dtype=torch.int32,
                          device=keys.device)
    starts = torch.searchsorted(sorted_keys, bounds, side="left")
    return order.to(torch.int32), starts.to(torch.int32)


def reference_position_segments_tables(
        inv: torch.Tensor, num_slots, keep: Optional[torch.Tensor] = None
        ) -> List[Segments]:
    """:func:`reference_position_segments` of T tables: ``inv`` int [T, N],
    ``keep`` bool [T, N] or None, ``num_slots`` one count or one per table.
    Tables of one slot count U take one stable sort over the composite int32
    key ``t * (U + 1) + key`` and one ``searchsorted`` over every table's
    bounds (each table's (order, starts) are views of the two results);
    tables of unequal counts take one build each."""
    t, n = inv.shape
    slots = _slot_counts(num_slots, t)
    if len(set(slots)) > 1:
        return [reference_position_segments(
            inv[i], u, None if keep is None else keep[i])
            for i, u in enumerate(slots)]
    stride = slots[0] + 1
    if t * stride >= 2 ** 31:
        raise ValueError(f"the segments' composite key t * (U + 1) + slot "
                         f"overflows int32 at T={t}, U={slots[0]}")
    dev = inv.device
    key = _segment_keys(inv, slots[0], keep)
    key = key + torch.arange(0, t * stride, stride, dtype=torch.int32,
                             device=dev)[:, None]
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    # Table t's positions hold sorted places [t*N, (t+1)*N): its order is
    # the sort's indices less t*N, and its starts the places of its bounds
    # t*stride + [0, U] less its first one's (t*N).
    order = torch.remainder(order, max(n, 1)).to(torch.int32).reshape(t, n)
    bounds = torch.arange(t * stride, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_key, bounds, side="left",
                                out_int32=True).reshape(t, stride)
    starts = starts - starts[:, :1]
    return [(order[i], starts[i]) for i in range(t)]


def _slot_counts(num_slots, t: int) -> List[int]:
    if isinstance(num_slots, int):
        return [int(num_slots)] * t
    slots = [int(u) for u in num_slots]
    if len(slots) != t:
        raise ValueError(f"{len(slots)} slot counts for {t} tables")
    return slots


def _launch_segments(inv: torch.Tensor, slots: List[int],
                     keep: Optional[torch.Tensor]) -> List[Segments]:
    """One ``dfm_segments`` launch for 1 to ``MAX_TABLES`` tables: inv
    int32 or int64 [T, N] (read as it is, no cast copy), keep bool [T, N]
    or None. order [T, N] and the tables' starts are allocated once; each
    table's pair are views of them."""
    t, n = inv.shape
    if inv.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"the CUDA segments kernel takes int32 or int64 inv, "
                        f"got {inv.dtype}")
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != inv.shape
                             or keep.device != inv.device):
        raise ValueError(f"segments keep must be bool {tuple(inv.shape)} on "
                         f"{inv.device}")
    if any(u < 0 or u >= 2 ** 31 - 1 for u in slots):
        raise ValueError(f"segments slot counts must lie in [0, 2^31 - 1), "
                         f"got {slots}")
    if t * n > 2 ** 30:
        raise ValueError(f"the segments kernel takes T * N up to 2^30 "
                         f"positions (int32 loops), got {t * n}")
    inv = inv.contiguous()
    keep = None if keep is None else keep.contiguous()
    dev = inv.device
    order = torch.empty((t, n), dtype=torch.int32, device=dev)
    starts = torch.empty(sum(slots) + t, dtype=torch.int32, device=dev)
    lib = _native.load("embedding")
    nbytes = lib.dfm_segments_scratch(t, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.dfm_segments(
            inv.data_ptr(), int(inv.dtype == torch.int64),
            None if keep is None else keep.data_ptr(),
            (ctypes.c_int64 * t)(*slots), t, n, order.data_ptr(),
            starts.data_ptr(), scratch.data_ptr(), nbytes, _stream(dev))
    _native.check(err, "position segments")
    _count("segments_launches")
    out, off = [], 0
    for i, u in enumerate(slots):
        out.append((order[i], starts[off:off + u + 1]))
        off += u + 1
    return out


def position_segments(inv: torch.Tensor, num_slots: int,
                      keep: Optional[torch.Tensor] = None) -> Segments:
    """(order int32 [N], starts int32 [num_slots+1]): the positions sorted
    by uid slot, ascending positions within a slot, and where each slot's
    run starts. Integer bookkeeping for the backward kernel, built once per
    plan (or per batch of dense lookups) and shared by every embedding
    name. A CUDA tensor launches the segments kernel (``dfm_segments``,
    one counting sort) or raises; a CPU tensor takes the plain version,
    :func:`reference_position_segments`. Both give the same result, which
    is unique.

    ``keep`` (bool, inv-shaped) leaves the other positions out of every
    run, as it does an inv outside [0, num_slots): they follow the last
    slot's run, in ascending position. For a position whose cotangent is
    always zero (a hashed table's masked position, whose view the mask
    multiplies by 0) that changes no sum, as adding +-0.0 to a float32 sum
    changes none, and it spares the fill slot, which collects every masked
    position, a serial walk over most of the batch."""
    _check_device(inv, "position segments")
    if inv.device.type == "cuda":
        return _launch_segments(
            inv.reshape(1, -1), [int(num_slots)],
            None if keep is None else keep.reshape(1, -1))[0]
    return reference_position_segments(inv, num_slots, keep)


def position_segments_tables(inv: torch.Tensor, num_slots,
                             keep: Optional[torch.Tensor] = None
                             ) -> List[Segments]:
    """:func:`position_segments` of T tables at once: ``inv`` int [T, N]
    (row t is table t's inv), ``keep`` bool [T, N] or None, ``num_slots``
    one count for every table or one per table. On CUDA tensors one
    segments launch serves up to ``MAX_TABLES`` tables; CPU tensors take
    :func:`reference_position_segments_tables`. Each table's (order,
    starts) equal :func:`position_segments` of that table bit for bit."""
    _check_device(inv, "position segments")
    t = inv.shape[0]
    slots = _slot_counts(num_slots, t)
    if inv.device.type != "cuda":
        return reference_position_segments_tables(inv, slots, keep)
    out = []
    for s in range(0, t, MAX_TABLES):
        part = slice(s, s + MAX_TABLES)
        out += _launch_segments(inv[part], slots[part],
                                None if keep is None else keep[part])
    return out


class SharedSegments:
    """One batch's gather ids for T tables, ``ids`` int [T, N] (row t
    indexes table t, of ``num_slots[t]`` rows), and their position
    segments, built at the first backward that asks for them (on the card:
    one :func:`position_segments_tables` call, one segments launch for up
    to ``MAX_TABLES`` tables) and then shared by every lookup that gathers
    with these ids: both embedding names of a dense step sort their
    positions once. ``keep`` (bool [T, N] or None) leaves the other
    positions out of every run: a row-sharded lookup's ids that another
    shard owns, whose cotangent the lookup zeroes (the CPU's plain sum adds
    their +0.0, which changes no sum)."""

    def __init__(self, ids: torch.Tensor, num_slots: Sequence[int],
                 keep: Optional[torch.Tensor] = None):
        if ids.dim() != 2 or len(num_slots) != ids.shape[0]:
            raise ValueError(f"shared segments need ids [T, N] and T slot "
                             f"counts; got {tuple(ids.shape)}, "
                             f"{len(num_slots)} counts")
        self.ids = ids
        self.num_slots = [int(u) for u in num_slots]
        self.keep = keep
        self._built: Optional[List[Segments]] = None
        self._lock = threading.Lock()  # backward passes may run on threads

    def segments(self, t: int) -> Segments:
        """Table t's (order, starts), built with every table's at the first
        call."""
        with self._lock:
            if self._built is None:
                self._built = position_segments_tables(
                    self.ids, self.num_slots, self.keep)
        return self._built[t]

    def rows(self, table: torch.Tensor, t: int = 0) -> torch.Tensor:
        """``table.index_select(0, ids[t])``, through :class:`IndexRows`
        where a gradient will flow to ``table``."""
        if table.shape[0] != self.num_slots[t]:
            raise ValueError(f"table {t} has {table.shape[0]} rows; these "
                             f"ids index {self.num_slots[t]}")
        idx = self.ids[t]
        if torch.is_grad_enabled() and table.requires_grad:
            return IndexRows.apply(table, idx, self, t)
        return table.index_select(0, idx)


def reference_take(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Plain forward: ``rows[inv]`` for rows [U, D], inv int [N] -> [N, D]."""
    return rows[inv.long()]


def reference_take_bwd(g: torch.Tensor, inv: torch.Tensor,
                       num_slots: int) -> torch.Tensor:
    """Plain backward: d_rows [U, D] = zeros then ``d_rows[inv[p]] += g[p]``
    for p ascending, in g's dtype (autograd's ``rows[inv]`` backward). On
    the CPU the adds run one position after another, so this is the
    position-order segment-sum; on the card they may run in another
    order."""
    out = torch.zeros((num_slots,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    return out.index_put_((inv.long(),), g, accumulate=True)


def _check_take(rows: torch.Tensor, inv: torch.Tensor) -> None:
    if rows.dim() != 2 or inv.dim() != 1:
        raise ValueError(f"take expects rows [U,D] and inv [N]; got "
                         f"{tuple(rows.shape)}, {tuple(inv.shape)}")
    if rows.device != inv.device:
        raise ValueError(f"take inputs on different devices: {rows.device}, "
                         f"{inv.device}")
    if rows.dtype not in _KERNEL_DTYPES or inv.dtype != torch.int32:
        raise TypeError(f"the CUDA take kernels take float32 or bfloat16 "
                        f"rows and int32 inv; got {rows.dtype}, {inv.dtype}")
    if not (rows.is_contiguous() and inv.is_contiguous()):
        raise ValueError("the CUDA take kernels need contiguous inputs")


def _check_take_tables(rows: Sequence[torch.Tensor],
                       inv: Sequence[torch.Tensor],
                       masks: Optional[Sequence[torch.Tensor]]) -> None:
    t = len(rows)
    if not 1 <= t <= MAX_TABLES:
        raise ValueError(f"a take launch serves 1 to {MAX_TABLES} tables, "
                         f"got {t}")
    if len(inv) != t or (masks is not None and len(masks) != t):
        raise ValueError(f"take needs one inv (and mask) per table: {t} "
                         f"tables, {len(inv)} invs, "
                         f"{None if masks is None else len(masks)} masks")
    for r, i in zip(rows, inv):
        _check_take(r, i)
    r0, n = rows[0], inv[0].shape[0]
    if any(r.shape[1:] != r0.shape[1:] or r.dtype != r0.dtype
           or r.device != r0.device for r in rows):
        raise ValueError("take tables need one width, dtype and device")
    if any(i.shape[0] != n for i in inv):
        raise ValueError(f"take invs of one length N; got "
                         f"{[i.shape[0] for i in inv]}")
    if masks is not None:
        if any(m.dtype != torch.float32 for m in masks):
            raise TypeError("take masks must be float32")
        if any(m.shape != (n,) or m.device != r0.device for m in masks):
            raise ValueError("take masks must be [N] on the rows' device")
        if not all(m.is_contiguous() for m in masks):
            raise ValueError("the CUDA take kernel needs contiguous inputs")
    if (masks is not None or t > 1) and r0.dtype != torch.float32:
        raise TypeError(f"masks or several tables take float32 rows, got "
                        f"{r0.dtype}")


def reference_take_sum(rows: Sequence[torch.Tensor],
                       inv: Sequence[torch.Tensor],
                       masks: Optional[Sequence[torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Plain fused forward: per table ``rows[inv]``, times its mask, summed
    in table order (the composition the kernel fuses). rows [U_t, D], inv
    int [N], masks float32 [N] -> [N, D]."""
    out = None
    for i, (r, v) in enumerate(zip(rows, inv)):
        part = reference_take(r, v)
        if masks is not None:
            part = part * masks[i][:, None]
        out = part if out is None else out + part
    return out


def _launch_take_fwd(rows: Sequence[torch.Tensor],
                     inv: Sequence[torch.Tensor],
                     masks: Optional[Sequence[torch.Tensor]] = None
                     ) -> torch.Tensor:
    _check_take_tables(rows, inv, masks)
    t, n, d = len(rows), inv[0].shape[0], rows[0].shape[1]
    dev = rows[0].device
    out = torch.empty((n, d), dtype=rows[0].dtype, device=dev)
    if n == 0 or d == 0:
        return out

    def ptrs(ts):
        return (ctypes.c_void_p * t)(*(x.data_ptr() for x in ts))

    lib = _native.load("embedding")
    with torch.cuda.device(dev):
        err = lib.dfm_take_fwd(
            ptrs(rows), ptrs(inv), None if masks is None else ptrs(masks),
            (ctypes.c_int64 * t)(*(r.shape[0] for r in rows)), t,
            out.data_ptr(), n, d, _KERNEL_DTYPES[rows[0].dtype],
            _stream(dev))
    _native.check(err, "take forward")
    _count("take_fwd_launches")
    return out


def _check_take_bwd(g: torch.Tensor,
                    segments: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    num_slots: Sequence[int]) -> None:
    if not 1 <= len(segments) <= MAX_TABLES or len(num_slots) != len(
            segments):
        raise ValueError(f"a take backward launch serves 1 to {MAX_TABLES} "
                         f"tables with one segments pair and slot count "
                         f"each; got {len(segments)} segments, "
                         f"{len(num_slots)} slot counts")
    if g.dim() != 2 or g.dtype not in _KERNEL_DTYPES or not g.is_contiguous():
        raise TypeError(f"the CUDA take backward takes a contiguous float32 "
                        f"or bfloat16 cotangent [N,D]; got {tuple(g.shape)} "
                        f"{g.dtype}")
    for (order, starts), u in zip(segments, num_slots):
        if (order.dtype != torch.int32 or starts.dtype != torch.int32
                or order.shape != g.shape[:1] or starts.shape != (u + 1,)
                or order.device != g.device or starts.device != g.device
                or not (order.is_contiguous() and starts.is_contiguous())):
            raise ValueError("the CUDA take backward needs contiguous int32 "
                             "segments (order [N], starts [U+1]) on the "
                             "cotangent's device")


def _long_run_counts(stats: torch.Tensor) -> dict:
    """A finished launch's long runs and their positions (``stats``,
    pinned), added to the module's totals."""
    global take_bwd_long_runs, take_bwd_long_positions
    runs, positions = (int(x) for x in stats.tolist())
    with _count_lock:
        take_bwd_long_runs += runs
        take_bwd_long_positions += positions
    return {"long_runs": runs, "long_positions": positions}


def _launch_take_bwd_tables(
        g: torch.Tensor,
        segments: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        num_slots: Sequence[int],
        long_stats: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """One ``dfm_take_bwd`` launch for every table that shares the
    cotangent ``g`` [N, D]: table t's [num_slots[t], D] segment sums over
    its ``segments[t]`` (order [N], starts [U_t+1]). ``long_stats``, an
    int64 [2] on the card or in pinned memory, receives the long runs the
    launch took and their positions; while tracing is on, and without
    it, a pinned pair of the launch's own goes to the open ``embed.bwd``
    span (:func:`trace_lib.add_counts`)."""
    num_slots = [int(u) for u in num_slots]
    _check_take_bwd(g, segments, num_slots)
    d = g.shape[1]
    outs = [torch.empty((u, d), dtype=g.dtype, device=g.device)
            for u in num_slots]
    run = [i for i, u in enumerate(num_slots) if u > 0]
    if not run or d == 0:
        return outs
    t = len(run)
    if long_stats is not None and (long_stats.dtype != torch.int64
                                   or long_stats.shape != (2,)):
        raise ValueError("long_stats is an int64 [2]")
    if long_stats is None and trace_lib.enabled():
        stats = torch.empty(2, dtype=torch.int64, pin_memory=True)
        if trace_lib.add_counts(lambda: _long_run_counts(stats)):
            long_stats = stats
    # One mask word per warp of 32 slots, as the kernel numbers them.
    long_mask = torch.empty(sum((num_slots[i] + 31) // 32 for i in run),
                            dtype=torch.int32, device=g.device)

    def ptrs(ts):
        return (ctypes.c_void_p * t)(*(x.data_ptr() for x in ts))

    lib = _native.load("embedding")
    with torch.cuda.device(g.device):
        err = lib.dfm_take_bwd(
            g.data_ptr(), ptrs(segments[i][0] for i in run),
            ptrs(segments[i][1] for i in run), ptrs(outs[i] for i in run),
            (ctypes.c_int64 * t)(*(num_slots[i] for i in run)), t,
            g.shape[0], d, _KERNEL_DTYPES[g.dtype], long_mask.data_ptr(),
            None if long_stats is None else long_stats.data_ptr(),
            _stream(g.device))
    _native.check(err, "take backward")
    _count("take_bwd_launches")
    return outs


def _launch_take_bwd(g: torch.Tensor, segments: Tuple[torch.Tensor,
                                                      torch.Tensor],
                     num_slots: int) -> torch.Tensor:
    """One table's take backward through :func:`_launch_take_bwd_tables`."""
    return _launch_take_bwd_tables(g, [segments], [num_slots])[0]


class TakeRowsSum(torch.autograd.Function):
    """``take_rows_pallas``'s custom VJP, fused over up to ``MAX_TABLES``
    tables with the hashed layout's masks: out[p] = sum over tables t, in
    order, of rows_t[inv_t[p]] * mask_t[p] (no product without masks), and
    d_rows_t[u] = sum over positions p with inv_t[p] = u of g[p] *
    mask_t[p], in ascending p. CPU tensors take the plain versions (the
    composition ``reference_take_sum`` and ``reference_take_bwd`` per
    table), CUDA tensors the kernels: one ``dfm_take_fwd`` launch, then one
    ``dfm_take_bwd`` launch for every table.

    ``segments`` (per table, or None) are the plans' position segments.
    A plan's segments leave out the positions whose mask is 0
    (``EmbeddingSchema.sparse_plan`` builds them so), and the mask is 1.0
    at every other position, so the backward passes g itself there, shared
    by every table: g * 1.0 is g. A table without them gets the segments
    of every position; with masks it then needs g * mask_t of its own and a
    launch of its own."""

    @staticmethod
    def forward(ctx, inv, masks, segments, *rows):
        ctx.save_for_backward(*inv, *(masks or ()))
        ctx.num_slots = [r.shape[0] for r in rows]
        ctx.segments = segments
        if rows[0].device.type == "cpu":
            _check_take_tables(rows, inv, masks)
            return reference_take_sum(rows, inv, masks)
        return _launch_take_fwd(rows, inv, masks)

    @staticmethod
    def backward(ctx, g):
        with trace_lib.span("embed.bwd", device=g.device):
            t = len(ctx.num_slots)
            saved = ctx.saved_tensors
            inv, masks = saved[:t], saved[t:] or None
            g = g.contiguous()
            segs = list(ctx.segments or [None] * t)
            if g.device.type == "cpu":
                grads = [reference_take_bwd(
                    g if masks is None else g * masks[i][:, None], v, u)
                    for i, (v, u) in enumerate(zip(inv, ctx.num_slots))]
            elif masks is None or all(s is not None for s in segs):
                segs = [position_segments(v, u) if s is None else s
                        for v, u, s in zip(inv, ctx.num_slots, segs)]
                grads = _launch_take_bwd_tables(g, segs, ctx.num_slots)
            else:
                grads = [_launch_take_bwd(g, s, u) if s is not None else
                         _launch_take_bwd(g * masks[i][:, None],
                                          position_segments(v, u), u)
                         for i, (v, u, s) in enumerate(zip(
                             inv, ctx.num_slots, segs))]
        return (None, None, None, *grads)


def segment_sum(g: torch.Tensor, ids: torch.Tensor, num_slots: int, *,
                mode: str = "auto",
                segments: Optional[Segments] = None) -> torch.Tensor:
    """[num_slots, ...]: out[u] = the sum of g[p] over the positions p with
    ids[p] = u, in ascending p from 0.0, for g [N, ...] and ids int [N] in
    [0, num_slots). On CUDA tensors the kernel leg makes one
    ``dfm_take_bwd`` launch over the ids' position segments (``segments``
    when the caller built them, else one segments launch here), so the sum
    no longer depends on the order of float atomics; CPU tensors and the
    other legs take the plain version, ``index_add_`` into zeros, which on
    the CPU adds one position after another."""
    shape = (num_slots,) + tuple(g.shape[1:])
    if g.device.type == "cuda" and resolve(mode, "take") == "kernel":
        seg = position_segments(ids, num_slots) if segments is None \
            else segments
        return _launch_take_bwd(g.reshape(g.shape[0], -1).contiguous(), seg,
                                num_slots).reshape(shape)
    return torch.zeros(shape, dtype=g.dtype, device=g.device).index_add_(
        0, ids.long(), g)


class IndexRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose gradient is
    :func:`segment_sum`: each row's cotangents summed in ascending
    position, the same on every run (``index_select``'s own backward is an
    ``index_add_`` with float atomics on the card). ``shared`` (a
    :class:`SharedSegments` whose row ``t`` is ``idx``) supplies the
    segments on the card, built once for every lookup that shares it."""

    @staticmethod
    def forward(ctx, table, idx, shared, t):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        ctx.shared, ctx.t = shared, t
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        with trace_lib.span("embed.bwd", device=g.device):
            idx, = ctx.saved_tensors
            seg = (ctx.shared.segments(ctx.t) if g.device.type == "cuda"
                   else None)
            return (segment_sum(g, idx, ctx.rows, segments=seg), None, None,
                    None)


def index_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx)`` (idx int64 in [0, rows)), through
    :class:`IndexRows` where a gradient will flow to ``table``: one
    lookup's own :class:`SharedSegments`."""
    return SharedSegments(idx.reshape(1, -1), [table.shape[0]]).rows(table)


def take_rows_sum(rows: Sequence[torch.Tensor], inv: Sequence[torch.Tensor],
                  masks: Optional[Sequence[torch.Tensor]] = None,
                  segments: Optional[Sequence[Optional[Tuple[
                      torch.Tensor, torch.Tensor]]]] = None) -> torch.Tensor:
    """The kernel leg's positionwise view over 1 to ``MAX_TABLES`` tables
    (:class:`TakeRowsSum`). rows: [U_t] or [U_t, D] per table (1-D handled
    as D = 1); inv: int32 [...] of one shape; masks: float32, inv-shaped
    -> [..., D] (or [...] for 1-D rows)."""
    _check_device(rows[0], "take")
    shape = tuple(inv[0].shape) + tuple(rows[0].shape[1:])
    rows2 = [r if r.dim() == 2 else r.unsqueeze(1) for r in rows]
    flat = [v.reshape(-1) for v in inv]
    m = None if masks is None else [x.reshape(-1) for x in masks]
    return TakeRowsSum.apply(flat, m, segments, *rows2).reshape(shape)


# ---------------------------------------------------------------------------
# Cache install (TPU kernel: pallas_embedding.py `_install_kernel`)
# ---------------------------------------------------------------------------
# One hot/cold transaction writes the fetched weight rows and their three
# lazy-Adam companions (m, v, tau) at their hot slots, in place; slots
# outside [0, H) (the pow-2 padding) are dropped. The in-bounds slots of a
# transaction are distinct, so every leg is element-identical.


def _in_bounds(slots: torch.Tensor, rows: int) -> torch.Tensor:
    return (slots >= 0) & (slots < rows)


@torch.no_grad()
def install_array(table: torch.Tensor, slots: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``table[slots] = vals`` in place with out-of-range slots dropped:
    one array of a transaction (the JAX ``_jit_install``, the ``off``
    leg). The masked select sizes its output from the data, so on the
    card it waits for the device."""
    keep = _in_bounds(slots, table.shape[0])
    table.index_copy_(0, slots[keep].long(), vals[keep].to(table.dtype))


@torch.no_grad()
def reference_install(w, m, v, tau, slots, wv, mv, vv, tv) -> None:
    """The install kernel's plain version (and the ``xla`` leg, the
    ``_install_fused_xla`` counterpart): four masked ``index_copy_`` calls
    that share one mask, in place."""
    keep = _in_bounds(slots, w.shape[0])
    idx = slots[keep].long()
    for table, vals in ((w, wv), (m, mv), (v, vv), (tau, tv)):
        table.index_copy_(0, idx, vals[keep].to(table.dtype))


def _check_install(w, m, v, tau, slots, wv, mv, vv, tv) -> None:
    h, p = w.shape[0], slots.shape[0]
    tabs, vals = (w, m, v), (wv, mv, vv)
    if (w.dim() not in (1, 2) or any(t.shape != w.shape for t in tabs)
            or tau.shape != (h,) or slots.dim() != 1
            or any(x.shape != (p,) + tuple(w.shape[1:]) for x in vals)
            or tv.shape != (p,)):
        raise ValueError(
            f"install expects w, m, v [H] or [H,D], tau [H], slots [P] and "
            f"values [P(,D)]; got w {tuple(w.shape)}, tau {tuple(tau.shape)}, "
            f"slots {tuple(slots.shape)}, wv {tuple(wv.shape)}, tv "
            f"{tuple(tv.shape)}")
    every = (*tabs, tau, slots, *vals, tv)
    if any(t.device != w.device for t in every):
        raise ValueError("install inputs lie on different devices")
    if (any(t.dtype != torch.float32 for t in (*tabs, *vals))
            or any(t.dtype != torch.int32 for t in (tau, slots, tv))):
        raise TypeError("the CUDA install kernel takes float32 w/m/v and "
                        "their values, int32 tau, slots and tau values")
    if not all(t.is_contiguous() for t in every):
        raise ValueError("the CUDA install kernel needs contiguous inputs")


def _check_install_tables(tables, slots, values) -> None:
    if not 1 <= len(tables) <= MAX_TABLES or len(values) != len(tables):
        raise ValueError(f"an install launch serves 1 to {MAX_TABLES} "
                         f"tables with one values tuple each; got "
                         f"{len(tables)} tables, {len(values)} values")
    for tab, vals in zip(tables, values):
        _check_install(*tab, slots, *vals)
    if any(tab[0].shape[0] != tables[0][0].shape[0] for tab in tables):
        raise ValueError(f"install tables sharing slots need one row count; "
                         f"got {[tab[0].shape[0] for tab in tables]}")


def _launch_install_tables(tables, slots, values) -> None:
    """One ``dfm_install`` launch for every table of the transaction:
    ``tables`` (w, m, v, tau) and ``values`` (wv, mv, vv, tv) per table,
    one ``slots`` for all."""
    _check_install_tables(tables, slots, values)
    h, p, t = tables[0][0].shape[0], slots.shape[0], len(tables)
    if p == 0:
        return
    ptrs = [x.data_ptr() for tab, vals in zip(tables, values)
            for x in (*tab, *vals)]
    widths = [1 if tab[0].dim() == 1 else tab[0].shape[1] for tab in tables]
    if 0 in widths:
        return
    lib = _native.load("embedding")
    dev = slots.device
    with torch.cuda.device(dev):
        err = lib.dfm_install((ctypes.c_void_p * (8 * t))(*ptrs),
                              (ctypes.c_int64 * t)(*widths), t,
                              slots.data_ptr(), h, p, _stream(dev))
    _native.check(err, "cache install")
    _count("install_launches")


def install_rows_tables(tables, slots, values, *, mode: str = "auto") -> None:
    """One cache transaction of 1 to ``MAX_TABLES`` tables that share
    ``slots`` [P], through the selected leg, in place: for each table, rows
    ``slots`` of its w, m, v [H(,D_t)] and tau [H] take its wv, mv, vv and
    tv; slots outside [0, H) are dropped. ``tables``: (w, m, v, tau) per
    table; ``values``: (wv, mv, vv, tv) per table. The kernel leg makes ONE
    ``dfm_install`` launch for all of them on CUDA tensors and takes
    :func:`reference_install` per table on CPU tensors; the ``xla`` and
    ``off`` legs take their plain versions per table."""
    tables = [tuple(tab) for tab in tables]
    values = [tuple(vals) for vals in values]
    _check_device(slots, "install")
    leg = resolve(mode, "install")
    if leg == "kernel" and slots.device.type == "cuda":
        _launch_install_tables(tables, slots, values)
        return
    for (w, m, v, tau), (wv, mv, vv, tv) in zip(tables, values):
        if leg == "ref":
            for table, vals in ((w, wv), (m, mv), (v, vv), (tau, tv)):
                install_array(table, slots, vals)
        else:
            reference_install(w, m, v, tau, slots, wv, mv, vv, tv)


def install_rows(w, m, v, tau, slots, wv, mv, vv, tv, *,
                 mode: str = "auto") -> None:
    """One table's cache transaction through
    :func:`install_rows_tables`."""
    install_rows_tables([(w, m, v, tau)], slots, [(wv, mv, vv, tv)],
                        mode=mode)
