"""Kernels of the sparse embedding plane, with their plain versions: the
counterpart of ``deepfm_tpu/ops/pallas_embedding.py`` (its plan build and
its gather/segment-sum pair; the hot/cold cache install is not ported).

Each seam has up to three legs, picked by :func:`resolve` from the
``--embedding_kernels`` mode as the JAX package picks them:

  * ``kernel`` (``auto``, ``pallas``) -- the hand-written CUDA kernels of
    ``csrc/embedding.cu`` on CUDA tensors. A CPU tensor takes the kernel's
    plain version instead; a CUDA tensor launches the kernel or raises.
  * ``opt`` (``xla``) -- the plain torch legs: the counting plan build and
    ``rows[inv]`` with autograd's own backward.
  * ``ref`` (``off``, and plans over more than ``PLAN_COUNT_MAX_ROWS``
    rows) -- the sort-based plan and ``rows[inv]``.

All legs give bit-identical plans. The take legs give identical values;
their backward sums each uid slot's cotangents in ascending batch position
from 0.0 on the CPU and in the kernel (the order of the TPU kernel's loop
and of XLA's scatter-add, so the gradient equals the JAX package's bit for
bit), while autograd's ``rows[inv]`` backward on the card may sum in
another order.

Launch counters are plain ints on this module: ``plan_launches``,
``take_fwd_launches`` and ``take_bwd_launches``, each raised by one where
its wrapper launches its kernel (one plan build is one count, whatever
number of CUDA launches it takes).
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


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def resolve(mode: str, kernel: str, *, num_rows: int = 0) -> str:
    """The leg ("kernel" | "opt" | "ref") of one seam ("plan" | "take")."""
    if mode not in MODES:
        raise ValueError(f"embedding_kernels must be one of {MODES}, "
                         f"got {mode!r}")
    if kernel not in ("plan", "take"):
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
