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

Launch counters are plain ints on this module: ``plan_launches``,
``take_fwd_launches``, ``take_bwd_launches`` and ``install_launches``, each
raised by one where its wrapper launches its kernel (one plan build is one
count, whatever number of CUDA launches it takes).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _native
from . import embedding as emb_ops

#: embedding_kernels values (config-validated).
MODES = ("auto", "pallas", "xla", "off")

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


def _launch_plan(ids: torch.Tensor, num_rows: int,
                 mask: Optional[torch.Tensor]) -> emb_ops.PlanEntry:
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    n = flat.numel()
    dev = flat.device
    uids = torch.empty(n, dtype=torch.int32, device=dev)
    inv = torch.empty(n, dtype=torch.int32, device=dev)
    touched = torch.empty(num_rows, dtype=torch.bool, device=dev)
    rank = torch.empty(num_rows + 1, dtype=torch.int32, device=dev)
    lib = _native.load("embedding")
    tiles = torch.empty(int(lib.dfm_plan_tiles(num_rows)), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        err = lib.dfm_plan_build(
            flat.data_ptr(), uids.data_ptr(), inv.data_ptr(),
            touched.data_ptr(), rank.data_ptr(), tiles.data_ptr(), n,
            num_rows, _stream(dev))
    _native.check(err, "plan build")
    _count("plan_launches")
    return emb_ops.PlanEntry(uids=uids, inv=inv.reshape(ids.shape), mask=mask,
                             num_rows=num_rows, touched=touched,
                             rank=rank[:num_rows])


def plan_build_kernel(ids: torch.Tensor, num_rows: int,
                      mask: Optional[torch.Tensor] = None
                      ) -> emb_ops.PlanEntry:
    """The counting plan with touched/rank: the CUDA kernel on a CUDA
    tensor, its plain version ``make_plan_counting`` on a CPU tensor."""
    _check_device(ids, "plan build")
    if ids.device.type == "cpu":
        return emb_ops.make_plan_counting(ids, num_rows, mask)
    return _launch_plan(ids, num_rows, mask)


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


def _launch_take_fwd(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    _check_take(rows, inv)
    n, (u, d) = inv.shape[0], rows.shape
    out = torch.empty((n, d), dtype=rows.dtype, device=rows.device)
    if n == 0 or d == 0:
        return out
    lib = _native.load("embedding")
    with torch.cuda.device(rows.device):
        err = lib.dfm_take_fwd(rows.data_ptr(), inv.data_ptr(),
                               out.data_ptr(), n, u, d,
                               _KERNEL_DTYPES[rows.dtype],
                               _stream(rows.device))
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


class TakeRows(torch.autograd.Function):
    """``take_rows_pallas``'s custom VJP: out[p] = rows[inv[p]], and
    d_rows[u] = sum over positions p with inv[p] = u of g[p], in ascending
    p. rows [U, D], inv int32 [N]; CPU tensors take the plain versions,
    CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, rows, inv, segments):
        ctx.save_for_backward(inv)
        ctx.num_slots = rows.shape[0]
        ctx.segments = segments
        if rows.device.type == "cpu":
            return reference_take(rows, inv)
        return _launch_take_fwd(rows.contiguous(), inv.contiguous())

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            return reference_take_bwd(g, inv, ctx.num_slots), None, None
        segments = ctx.segments
        if segments is None:
            segments = position_segments(inv, ctx.num_slots)
        return _launch_take_bwd(g, segments, ctx.num_slots), None, None


def take_rows(rows: torch.Tensor, inv: torch.Tensor, *, mode: str = "auto",
              segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """rows[inv] through the selected leg. rows: [U] or [U, D]; inv: int
    [...] -> [..., D] (or [...] for 1-D rows, handled as D = 1).
    ``segments`` (``position_segments(inv, U)``) lets the backward kernel
    skip rebuilding them."""
    _check_device(rows, "take")
    if resolve(mode, "take") != "kernel":
        return reference_take(rows, inv)
    rows2 = rows if rows.dim() == 2 else rows.unsqueeze(1)
    flat = inv.reshape(-1).to(torch.int32)
    out = TakeRows.apply(rows2, flat, segments)
    return out.reshape(tuple(inv.shape) + tuple(rows.shape[1:]))


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
