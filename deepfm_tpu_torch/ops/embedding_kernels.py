"""Kernels of the sparse embedding plane, with their plain versions: the
counterpart of ``deepfm_tpu/ops/pallas_embedding.py`` (its plan build, its
gather/segment-sum pair and the hot/cold tier's cache install).

Each seam has up to three legs, picked by :func:`resolve` from the
``--embedding_kernels`` mode as the JAX package picks them:

  * ``kernel`` (``auto``, ``pallas``) -- the hand-written CUDA kernels of
    ``csrc/embedding.cu`` on CUDA tensors. A CPU tensor takes the kernel's
    plain version instead; a CUDA tensor launches the kernel or raises.
  * ``opt`` (``xla``) -- the plain torch legs: the counting plan build,
    ``rows[inv]`` with autograd's own backward, and the install's four
    masked copies under one mask (``reference_install``).
  * ``ref`` (``off``, and plans over more than ``PLAN_COUNT_MAX_ROWS``
    rows) -- the sort-based plan, ``rows[inv]``, and one masked copy per
    array (``install_array``, the JAX ``_jit_install``).

All legs give bit-identical plans and installs. The take legs give
identical values; their backward sums each uid slot's cotangents in
ascending batch position from 0.0 on the CPU and in the kernel (the order
of the TPU kernel's loop and of XLA's scatter-add, so the gradient equals
the JAX package's bit for bit), while autograd's ``rows[inv]`` backward on
the card may sum in another order.

The plan build and the take forward serve up to ``MAX_TABLES`` tables in
one launch: a hashed step builds all its tables' plans with one launch
(:func:`plan_build_tables`) and views each embedding name's tables, masks
and table sum with one more (:func:`take_rows_sum`).

Launch counters are plain ints on this module: ``plan_launches``,
``take_fwd_launches``, ``take_bwd_launches`` and ``install_launches``, each
raised by one where its wrapper launches its kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _native
from . import embedding as emb_ops

#: embedding_kernels values (config-validated).
MODES = ("auto", "pallas", "xla", "off")

#: Tables one plan-build or take-forward launch serves
#: (``csrc/embedding.cu`` ``kMaxTables``).
MAX_TABLES = 8

# The counting plan build does a [rows+1] prefix sum; above this many rows
# the sort-based build is kept (``deepfm_tpu.ops.pallas_embedding``).
PLAN_COUNT_MAX_ROWS = 2_000_000

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()

plan_launches = 0
take_fwd_launches = 0
take_bwd_launches = 0
install_launches = 0


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def resolve(mode: str, kernel: str, *, num_rows: int = 0) -> str:
    """The leg ("kernel" | "opt" | "ref") of one seam ("plan" | "take" |
    "install")."""
    if mode not in MODES:
        raise ValueError(f"embedding_kernels must be one of {MODES}, "
                         f"got {mode!r}")
    if kernel not in ("plan", "take", "install"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if mode == "off":
        return "ref"
    if kernel == "plan" and num_rows > PLAN_COUNT_MAX_ROWS:
        return "ref"
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


def position_segments(inv: torch.Tensor, num_slots: int,
                      keep: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order int32 [N], starts int32 [num_slots+1]): the positions sorted
    by uid slot, ascending positions within a slot (a stable sort), and
    where each slot's run starts. Integer bookkeeping for the backward
    kernel, built once per plan and shared by every embedding name.

    ``keep`` (bool, inv-shaped) leaves the other positions out of every
    run: for a position whose cotangent is always zero (a hashed table's
    masked position, whose view the mask multiplies by 0) that changes no
    sum, as adding +-0.0 to a float32 sum changes none, and it spares the
    fill slot, which collects every masked position, a serial walk over
    most of the batch."""
    flat = inv.reshape(-1).to(torch.int32)
    if keep is not None:
        flat = torch.where(keep.reshape(-1), flat, torch.full(
            (), num_slots, dtype=torch.int32, device=flat.device))
    sorted_inv, order = torch.sort(flat, stable=True)
    bounds = torch.arange(num_slots + 1, dtype=torch.int32,
                          device=flat.device)
    starts = torch.searchsorted(sorted_inv, bounds, side="left")
    return order.to(torch.int32), starts.to(torch.int32)


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


def _launch_take_bwd(g: torch.Tensor, segments: Tuple[torch.Tensor,
                                                      torch.Tensor],
                     num_slots: int) -> torch.Tensor:
    order, starts = segments
    if g.dim() != 2 or g.dtype not in _KERNEL_DTYPES or not g.is_contiguous():
        raise TypeError(f"the CUDA take backward takes a contiguous float32 "
                        f"or bfloat16 cotangent [N,D]; got {tuple(g.shape)} "
                        f"{g.dtype}")
    if (order.dtype != torch.int32 or starts.dtype != torch.int32
            or order.shape != g.shape[:1]
            or starts.shape != (num_slots + 1,)
            or order.device != g.device or starts.device != g.device):
        raise ValueError("the CUDA take backward needs int32 segments "
                         "(order [N], starts [U+1]) on the cotangent's "
                         "device")
    d = g.shape[1]
    out = torch.empty((num_slots, d), dtype=g.dtype, device=g.device)
    if num_slots == 0 or d == 0:
        return out
    lib = _native.load("embedding")
    with torch.cuda.device(g.device):
        err = lib.dfm_take_bwd(g.data_ptr(), order.contiguous().data_ptr(),
                               starts.contiguous().data_ptr(), out.data_ptr(),
                               num_slots, d, _KERNEL_DTYPES[g.dtype],
                               _stream(g.device))
    _native.check(err, "take backward")
    _count("take_bwd_launches")
    return out


class TakeRowsSum(torch.autograd.Function):
    """``take_rows_pallas``'s custom VJP, fused over up to ``MAX_TABLES``
    tables with the hashed layout's masks: out[p] = sum over tables t, in
    order, of rows_t[inv_t[p]] * mask_t[p] (no product without masks), and
    d_rows_t[u] = sum over positions p with inv_t[p] = u of g[p] *
    mask_t[p], in ascending p. CPU tensors take the plain versions (the
    composition ``reference_take_sum`` and ``reference_take_bwd`` per
    table), CUDA tensors the kernels: one ``dfm_take_fwd`` launch, then one
    ``dfm_take_bwd`` launch per table.

    ``segments`` (per table, or None) are the plans' position segments.
    A plan's segments leave out the positions whose mask is 0
    (``EmbeddingSchema.sparse_plan`` builds them so), and the mask is 1.0
    at every other position, so the backward passes g itself there: g *
    1.0 is g. Without them it builds the segments of every position and
    passes g * mask_t."""

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
        t = len(ctx.num_slots)
        saved = ctx.saved_tensors
        inv, masks = saved[:t], saved[t:] or None
        g = g.contiguous()
        cpu = g.device.type == "cpu"
        grads = []
        for i, (v, u) in enumerate(zip(inv, ctx.num_slots)):
            seg = None if ctx.segments is None else ctx.segments[i]
            g_t = g
            if masks is not None and (cpu or seg is None):
                g_t = g * masks[i][:, None]
            if cpu:
                grads.append(reference_take_bwd(g_t, v, u))
            else:
                grads.append(_launch_take_bwd(
                    g_t, position_segments(v, u) if seg is None else seg, u))
        return (None, None, None, *grads)


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


def _launch_install(w, m, v, tau, slots, wv, mv, vv, tv) -> None:
    _check_install(w, m, v, tau, slots, wv, mv, vv, tv)
    h, p = w.shape[0], slots.shape[0]
    d = 1 if w.dim() == 1 else w.shape[1]
    if p == 0 or d == 0:
        return
    lib = _native.load("embedding")
    with torch.cuda.device(w.device):
        err = lib.dfm_install(*(t.data_ptr() for t in (
            w, m, v, tau, slots, wv, mv, vv, tv)), h, p, d,
            _stream(w.device))
    _native.check(err, "cache install")
    _count("install_launches")


def install_rows(w, m, v, tau, slots, wv, mv, vv, tv, *,
                 mode: str = "auto") -> None:
    """One cache transaction through the selected leg, in place: rows
    ``slots`` of w, m, v [H(,D)] and tau [H] take wv, mv, vv and tv; slots
    outside [0, H) are dropped. The kernel leg launches ``dfm_install`` on
    CUDA tensors and takes :func:`reference_install` on CPU tensors."""
    _check_device(w, "install")
    leg = resolve(mode, "install")
    if leg == "kernel" and w.device.type == "cuda":
        _launch_install(w, m, v, tau, slots, wv, mv, vv, tv)
    elif leg == "ref":
        for table, vals in ((w, wv), (m, mv), (v, vv), (tau, tv)):
            install_array(table, slots, vals)
    else:
        reference_install(w, m, v, tau, slots, wv, mv, vv, tv)
