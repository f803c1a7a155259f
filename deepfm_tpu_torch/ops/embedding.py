"""Embedding ops for one device (port of ``deepfm_tpu.ops.embedding``
without the row-sharded exchange): the dense lookup, the stateless id
hashing of the multi-table layout, and the sparse-update plan with its row
gather, positionwise view and writeback.

``lookup`` reproduces ``jnp.take``'s semantics, not ``torch.index_select``'s:
an id in ``[-V, 0)`` wraps to ``id + V``, and any other out-of-range id gives
a row of NaN. ``index_select`` would instead hit a device-side assert on the
card, which poisons the CUDA context for every later request of the
process; NaN rows make a bad id visible in that request's output alone.

The gradient matches the VJP of ``jnp.take``: a wrapped id scatters into
row ``id + V`` and an out-of-range id contributes nothing (its NaN row is
masked out with ``torch.where``, whose gradient there is zero, and +0.0
changes no sum that starts from +0.0). The gather goes through
``embedding_kernels.SharedSegments``, whose backward sums each row's
cotangents in ascending position from 0.0: ``index_add_`` on the CPU, the
take backward kernel on the card, over position segments built once per
batch for every name that gathers with the same ids. ``index_select``'s
own backward would use float atomics on the card, whose order, and with it
the last bits of a table gradient, changes from run to run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import embedding_kernels

# Vocab rows are padded to a multiple of this regardless of the mesh, so a
# table's shape (and every artifact) is the same on any power-of-two
# row-sharding up to 64-way (``deepfm_tpu.ops.embedding._VOCAB_PAD_MULTIPLE``).
_VOCAB_PAD_MULTIPLE = 64


def padded_vocab(feature_size: int, num_shards: int) -> int:
    """Round the vocabulary up to a multiple of 64 (and of ``num_shards``).

    Pad rows are zero-initialised and unreachable from real ids."""
    m = math.lcm(_VOCAB_PAD_MULTIPLE, max(num_shards, 1))
    return ((feature_size + m - 1) // m) * m


class DenseIds(NamedTuple):
    """One batch's ids as the dense lookup reads them from tables of one
    height V (:func:`dense_ids`)."""
    ok: torch.Tensor                                # bool, ids-shaped
    shared: "embedding_kernels.SharedSegments"      # safe ids [1, N]


def dense_ids(ids: torch.Tensor, num_rows: int) -> DenseIds:
    """``ok`` marks the ids in [-V, V); ``shared`` holds them wrapped into
    [0, V) (any other id reads row 0, masked out after the gather) with
    their position segments, which are built at most once for every table
    that gathers with them (fm_w and fm_v of one batch)."""
    ids = ids.long()
    ok = (ids >= -num_rows) & (ids < num_rows)
    safe = torch.where(ok, torch.where(ids < 0, ids + num_rows, ids),
                       torch.zeros((), dtype=ids.dtype, device=ids.device))
    return DenseIds(ok, embedding_kernels.SharedSegments(
        safe.reshape(1, -1), [num_rows]))


def lookup(table: torch.Tensor, ids: torch.Tensor,
           dense: Optional[DenseIds] = None) -> torch.Tensor:
    """Gather rows of ``table`` [V, ...] at integer ``ids`` [...].

    Returns [..., *table.shape[1:]] with ``jnp.take`` semantics (see the
    module docstring). ``dense``: :func:`dense_ids` of these ids, shared
    with the batch's other lookups (built here when None)."""
    ok, shared = dense_ids(ids, table.shape[0]) if dense is None else dense
    out = shared.rows(table).reshape(*ids.shape, *table.shape[1:])
    ok = ok.reshape(*ids.shape, *([1] * (table.dim() - 1)))
    return torch.where(ok, out, torch.full((), float("nan"), dtype=out.dtype,
                                           device=out.device))


def pad_row_mask(num_rows: int, feature_size: int, *,
                 device=None) -> torch.Tensor:
    """Bool [num_rows]: True for real vocabulary rows, False for the
    ``padded_vocab`` pad rows after them (one device: no shard offset)."""
    return torch.arange(num_rows, device=device) < feature_size


def mask_pad_rows(x: torch.Tensor, feature_size: int) -> torch.Tensor:
    """Zero the pad rows of a table-shaped array (the dense path's embedding
    gradients: pad rows hold zeros and the l2 term excludes them, so this
    makes their zero update a structural guarantee)."""
    if x.shape[0] <= feature_size:
        return x
    keep = pad_row_mask(x.shape[0], feature_size, device=x.device)
    keep = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def trailing_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` with trailing singleton dims up to ``ndim`` dims, so a per-row
    or per-position vector broadcasts against rows of any width."""
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


# ---------------------------------------------------------------------------
# Deterministic id hashing (multi-table bucketed embeddings)
# ---------------------------------------------------------------------------
# The JAX package mixes ids in uint32 (Knuth multiplicative + murmur3
# fmix32). torch has no uint32 arithmetic worth the name, so the port works
# in int64 holding values in [0, 2^32): every product is split at 16 bits so
# that no intermediate reaches 2^63 (no signed overflow anywhere), and every
# result is masked back to 32 bits. The bits equal the JAX package's.

_MASK32 = 0xFFFFFFFF
_KNUTH = 2654435761        # 2^32 / golden ratio
_MIX1 = 0x85EBCA6B         # murmur3 fmix32 constants
_MIX2 = 0xC2B2AE35
TABLE_ASSIGN_SALT = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a 32-bit ``c``:
    x*c_lo < 2^48 and the high half only matters mod 2^16."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_mix(ids: torch.Tensor, salt: int) -> torch.Tensor:
    """Avalanche-mix ids (any int dtype) into uniform uint32 values, held in
    int64. Negative ids wrap as a uint32 cast wraps them."""
    x = (ids.long() & _MASK32) ^ (salt & _MASK32)
    x = _mul32(x, _KNUTH)
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def hash_bucket(ids: torch.Tensor, num_buckets: int,
                salt: int) -> torch.Tensor:
    """int32 bucket in [0, num_buckets) per id; table ``salt`` gives every
    table its own bucketing."""
    return (hash_mix(ids, salt) % num_buckets).to(torch.int32)


def hash_table_assign(ids: torch.Tensor, num_tables: int) -> torch.Tensor:
    """int32 table index in [0, num_tables) per id (embedding_assign=hash)."""
    return (hash_mix(ids, TABLE_ASSIGN_SALT) % num_tables).to(torch.int32)


# ---------------------------------------------------------------------------
# Sparse-update plan: static-shape dedup of one batch's ids
# ---------------------------------------------------------------------------


class PlanEntry(NamedTuple):
    """Dedup of one batch's ids against ONE physical table (the JAX
    ``PlanEntry``, plus the take backward's position segments).

    uids: int32 [N]    sorted unique row ids, N = ids.numel(). Slots past
                       the real uniques hold ``num_rows``: out of bounds, so
                       gathers read zero and writebacks drop them.
    inv:  int32 [...]  ids-shaped map position -> uid slot.
    mask: f32   [...]  1.0 where the position reads this table (hashed
                       layout), else 0.0. None = every position.
    num_rows: int      the table's rows, used as the out-of-bounds fill id.
    touched: bool [R]  (counting plans) per-row touch marks.
    rank: int32 [R]    (counting plans) row -> uid slot, read under touched.
    segments:          (order int32 [N], starts int32 [N+1]): the positions
                       grouped by uid slot in ascending position order
                       (masked positions left out), for the take backward
                       kernel; built once per plan on the card
                       (``embedding_kernels.position_segments``, the
                       segments kernel), None elsewhere.
    """
    uids: torch.Tensor
    inv: torch.Tensor
    mask: Optional[torch.Tensor]
    num_rows: int
    touched: Optional[torch.Tensor] = None
    rank: Optional[torch.Tensor] = None
    segments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def plan_ids(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Flat int32 ids with every id outside [0, num_rows] read as the fill
    id ``num_rows`` (the plan kernel's rule; the JAX package's callers never
    produce one)."""
    flat = ids.reshape(-1).to(torch.int32)
    bad = (flat < 0) | (flat > num_rows)
    return torch.where(bad, torch.full((), num_rows, dtype=torch.int32,
                                       device=flat.device), flat)


def make_plan(ids: torch.Tensor, num_rows: int,
              mask: Optional[torch.Tensor] = None) -> PlanEntry:
    """The sort leg: ``torch.unique(sorted=True, return_inverse=True)``
    padded to N with the fill id, which is ``jnp.unique(size=N,
    fill_value=num_rows)``. Masked positions must carry ``num_rows``. The
    unique count is data-dependent, so on the card this leg synchronises."""
    flat = plan_ids(ids, num_rows)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    uids = torch.full_like(flat, num_rows)
    uids[:uniq.numel()] = uniq
    return PlanEntry(uids=uids, inv=inv.reshape(ids.shape).to(torch.int32),
                     mask=mask, num_rows=num_rows)


def make_plan_counting(ids: torch.Tensor, num_rows: int,
                       mask: Optional[torch.Tensor] = None) -> PlanEntry:
    """``make_plan`` with bit-identical uids/inv, built by counting over the
    [num_rows+1] id space (``deepfm_tpu.ops.embedding.make_plan_counting``):

        mark[r] = 1 iff r occurs;  csum = inclusive prefix sum of mark
        rank = csum - mark;  inv = rank[ids];  uids[j] = searchsorted(csum, j+1)

    clamped to the fill id. Also returns the touched/rank companions. This
    is the plan kernel's plain version."""
    flat = plan_ids(ids, num_rows)
    n = flat.numel()
    mark = torch.zeros(num_rows + 1, dtype=torch.int32, device=flat.device)
    mark[flat.long()] = 1
    csum = torch.cumsum(mark, 0, dtype=torch.int32)
    rank = csum - mark
    inv = rank[flat.long()]
    want = torch.arange(1, n + 1, dtype=torch.int32, device=flat.device)
    uids = torch.clamp(torch.searchsorted(csum, want, side="left"),
                       max=num_rows).to(torch.int32)
    return PlanEntry(uids=uids, inv=inv.reshape(ids.shape), mask=mask,
                     num_rows=num_rows, touched=mark[:num_rows] > 0,
                     rank=rank[:num_rows])


def valid_rows(entry: PlanEntry) -> torch.Tensor:
    """Bool [N]: which uid slots name a real (in-bounds) touched row."""
    return entry.uids < entry.num_rows


def gather_rows(table: torch.Tensor, entry: PlanEntry) -> torch.Tensor:
    """[N, ...] rows at ``entry.uids``; fill slots read ZERO (the JAX
    ``mode="fill", fill_value=0``), never NaN."""
    valid = valid_rows(entry)
    safe = torch.where(valid, entry.uids, torch.zeros((), dtype=entry.uids.dtype,
                                                     device=valid.device))
    out = table.index_select(0, safe.long())
    return torch.where(trailing_dims(valid, out.dim()), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def lookup_rows(rows: torch.Tensor, entry: PlanEntry, *,
                mode: str = "auto") -> torch.Tensor:
    """Positionwise view ``rows[inv]`` of gathered rows, times the mask in
    the hashed layout. The kernel leg fuses both in one take
    (``embedding_kernels.take_rows_sum``), whose gradient with respect to
    ``rows`` is the position-order segment-sum."""
    if embedding_kernels.resolve(mode, "take") == "kernel":
        masks = None if entry.mask is None else [entry.mask]
        return embedding_kernels.take_rows_sum([rows], [entry.inv], masks,
                                               [entry.segments])
    out = embedding_kernels.reference_take(rows, entry.inv)
    if entry.mask is not None:
        out = out * trailing_dims(entry.mask, out.dim())
    return out


def _write_slots(entry: PlanEntry):
    """(row index, source slot, any real slot) for a scatter writeback
    without a host sync. The fill slots sit after the real ones (uids are
    ascending and the fill id is the largest), so fill slot j is redirected
    to repeat real slot j mod n_real's write: the same row with the same
    value, which leaves the result what dropping them gives. Spreading the
    repeats over every real row keeps them from piling onto one address
    (in a hashed table most slots are fill)."""
    n = entry.uids.shape[0]
    n_real = valid_rows(entry).sum()
    slot = torch.arange(n, device=entry.uids.device)
    src = torch.where(slot < n_real, slot,
                      torch.remainder(slot, torch.clamp(n_real, min=1)))
    idx = entry.uids.index_select(0, src).long()
    return idx, src, n_real > 0


def scatter_rows(table: torch.Tensor, entry: PlanEntry,
                 new_rows: torch.Tensor) -> torch.Tensor:
    """Write updated touched rows back into ``table``, IN PLACE (the JAX
    package returns a new array; the port's state tensors are updated where
    they lie); returns ``table``. Fill slots are dropped. Counting plans
    (touched/rank present) write back as a select over the id space,
    ``where(touched, new_rows[rank], table)``, element-identical."""
    with torch.no_grad():
        if entry.touched is not None:
            rows = table.shape[0]
            keep = trailing_dims(entry.touched[:rows], table.dim())
            sel = new_rows.index_select(0, entry.rank[:rows].long())
            table.copy_(torch.where(keep, sel.to(table.dtype), table))
            return table
        idx, src, any_real = _write_slots(entry)
        vals = new_rows.index_select(0, src).to(table.dtype)
        # No real slot at all: rewrite row 0 with its own bits.
        idx = torch.where(any_real, idx, torch.zeros_like(idx))
        vals = torch.where(any_real, vals, table[:1])
        table.index_copy_(0, idx, vals)
    return table


def set_rows_scalar(table: torch.Tensor, entry: PlanEntry,
                    value) -> torch.Tensor:
    """Set every touched row of a rank-1 per-row tensor (the lazy-Adam
    ``tau`` stamps) to ``value``, in place, as :func:`scatter_rows` writes;
    returns ``table``."""
    with torch.no_grad():
        v = torch.as_tensor(value, dtype=table.dtype, device=table.device)
        if entry.touched is not None:
            keep = entry.touched[:table.shape[0]]
            table.copy_(torch.where(keep, v, table))
            return table
        idx, _, any_real = _write_slots(entry)
        idx = torch.where(any_real, idx, torch.zeros_like(idx))
        vals = torch.where(any_real, v, table[0]).expand(idx.shape[0])
        table.index_copy_(0, idx, vals.contiguous())
    return table
