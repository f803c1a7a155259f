"""Embedding ops (port of ``deepfm_tpu.ops.embedding``): the dense lookup,
the stateless id hashing of the multi-table layout, the sparse-update plan
with its row gather, positionwise view and writeback, and the model axis:
lookups from tables row-sharded over ``--mesh_model`` ranks and the row
exchange of ``--embedding_shard rows``.

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

The model axis. A rank holds shard ``index`` of ``size``: rows
``[index * R, (index + 1) * R)`` of each table (``R = rows / size``), and
its model peers see the same batch. There is no ``axis_index`` in
PyTorch, so every function here takes the shard index (and the peers'
process group, :class:`ModelAxis`) explicitly. ``sharded_lookup`` gathers
the ids this shard owns from its rows (the others read zero and are left
out of the gradient's position segments) and sums the peers' parts with one
all_reduce: each element has one nonzero part, so the result equals the
one-device lookup bit for bit. Its backward is the identity: the cotangent
of the summed lookup is the same on every peer, and each peer's shard
gradient is its slice of the one-device gradient (an autograd all_reduce
would sum the peers' equal cotangents, M times too much).
``sharded_lookup_allgather`` all-gathers the table and gathers from it; its
backward keeps the rank's slice of the full table's cotangent. The sparse
update's row exchange (``build_exchange``, ``exchange_rows``,
``owner_scatter_add``) moves only the plan's rows: two ``all_to_all``s and
one all_reduce, again one nonzero part per element.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

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


def pad_row_mask(num_rows: int, feature_size: int, *, offset: int = 0,
                 device=None) -> torch.Tensor:
    """Bool [num_rows]: True for real vocabulary rows, False for the
    ``padded_vocab`` pad rows after them. ``offset``: the global row of a
    shard's first row (0 on one device)."""
    return torch.arange(num_rows, device=device) + offset < feature_size


def mask_pad_rows(x: torch.Tensor, feature_size: int,
                  offset: int = 0) -> torch.Tensor:
    """Zero the pad rows of a table-shaped array (the dense path's embedding
    gradients: pad rows hold zeros and the l2 term excludes them, so this
    makes their zero update a structural guarantee). ``offset`` as in
    :func:`pad_row_mask`."""
    if offset + x.shape[0] <= feature_size:
        return x
    keep = pad_row_mask(x.shape[0], feature_size, offset=offset,
                        device=x.device)
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
    # index_fill_, not ``mark[ids] = 1``: that copies the scalar to the card
    # from pageable memory, which waits for every queued launch.
    mark.index_fill_(0, flat.long(), 1)
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


def spread_index(entry: PlanEntry, spread: torch.Tensor) -> torch.Tensor:
    """int32 [N]: each uid slot's table row, fill slot s at ``spread[s]``
    (int32 [N], s mod rows: spread over the table, not piled on one row).
    A gather at it reads real rows in the fill slots, and an add at it that
    gives the fill slots zero changes no row: for a caller that needs no
    zero fill."""
    return torch.where(valid_rows(entry), entry.uids, spread)


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


# ---------------------------------------------------------------------------
# The model axis: tables row-sharded over --mesh_model ranks
# ---------------------------------------------------------------------------


class ModelAxis(NamedTuple):
    """This rank's place on the model axis: shard ``index`` of ``size``,
    and ``group``, the process group of its model peers (None: the default
    group, when the model axis spans every rank)."""
    index: int
    size: int
    group: Any = None


def shard_rows(table: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This shard's rows of a full table-shaped tensor (a copy)."""
    rows = table.shape[0] // axis.size
    if rows * axis.size != table.shape[0]:
        raise ValueError(f"table rows {table.shape[0]} not divisible by "
                         f"{axis.size} shards")
    return table[axis.index * rows:(axis.index + 1) * rows].clone()


class _SumOverPeers(torch.autograd.Function):
    """all_reduce (sum) over the model peers; the backward is the
    identity (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """The peers' shards concatenated in shard order; the backward keeps
    this shard's rows of the full cotangent."""

    @staticmethod
    def forward(ctx, local, axis):
        ctx.index, ctx.rows = axis.index, local.shape[0]
        parts = [torch.empty_like(local) for _ in range(axis.size)]
        dist.all_gather(parts, local.contiguous(), group=axis.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        off = ctx.index * ctx.rows
        return g[off:off + ctx.rows], None


def sum_over_peers(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The model peers' ``x`` summed (the JAX ``psum`` over ``'model'``)."""
    return _SumOverPeers.apply(x, axis.group)


def gather_table(local: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The full table from every peer's shard (the JAX all-gather
    reassembly)."""
    return _GatherRows.apply(local, axis)


class ShardedIds(NamedTuple):
    """One batch's ids as a row-sharded lookup reads them
    (:func:`sharded_ids`)."""
    ok: torch.Tensor                                # bool: ids in [-V, V)
    mine: torch.Tensor                              # bool: owned here
    shared: "embedding_kernels.SharedSegments"      # local ids [1, N]


def sharded_ids(ids: torch.Tensor, rows_local: int,
                axis: ModelAxis) -> ShardedIds:
    """``ok`` marks the ids in [-V, V) of the full height V = rows_local *
    size (wrapped as :func:`dense_ids` wraps them), ``mine`` those this
    shard owns; ``shared`` holds the local ids (0 where not mine) and
    leaves the other positions out of the gradient's segments."""
    ids = ids.long()
    v = rows_local * axis.size
    ok = (ids >= -v) & (ids < v)
    local = torch.where(ids < 0, ids + v, ids) - axis.index * rows_local
    mine = ok & (local >= 0) & (local < rows_local)
    safe = torch.where(mine, local, torch.zeros((), dtype=local.dtype,
                                                device=local.device))
    return ShardedIds(ok, mine, embedding_kernels.SharedSegments(
        safe.reshape(1, -1), [rows_local], keep=mine.reshape(1, -1)))


def sharded_lookup(local_table: torch.Tensor, ids: torch.Tensor,
                   axis: ModelAxis,
                   index: Optional[ShardedIds] = None) -> torch.Tensor:
    """Row-sharded gather: the local masked take, then one all_reduce over
    the model peers (identity backward). Equals :func:`lookup` on the full
    table bit for bit, NaN rows for out-of-range ids included. ``index``:
    :func:`sharded_ids` of these ids, shared with the batch's other
    lookups."""
    if index is None:
        index = sharded_ids(ids, local_table.shape[0], axis)
    ok, mine, shared = index
    out = shared.rows(local_table).reshape(*ids.shape,
                                           *local_table.shape[1:])
    tail = [1] * (local_table.dim() - 1)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    out = sum_over_peers(torch.where(mine.reshape(*ids.shape, *tail), out,
                                     zero), axis)
    return torch.where(ok.reshape(*ids.shape, *tail), out,
                       torch.full((), float("nan"), dtype=out.dtype,
                                  device=out.device))


def sharded_lookup_allgather(local_table: torch.Tensor, ids: torch.Tensor,
                             axis: ModelAxis,
                             dense: Optional[DenseIds] = None
                             ) -> torch.Tensor:
    """Row-sharded gather through the reassembled table: all-gather the
    shards, then :func:`lookup` (``dense``: :func:`dense_ids` over the full
    height). Traffic grows with the table, not the batch."""
    return lookup(gather_table(local_table, axis), ids, dense)


def _all_to_all(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Block j of ``x`` [D * C, ...] to peer j; returns the D blocks
    received, in peer order. gloo moves CUDA tensors through host copies
    (:func:`exchange_transport`)."""
    x = x.contiguous()
    if exchange_transport(axis, x.device) == "host":
        host = x.cpu()
        got = torch.empty_like(host)
        dist.all_to_all_single(got, host, group=axis.group)
        return got.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def exchange_transport(axis: ModelAxis, device) -> str:
    """How the row exchange's all_to_all moves a tensor on ``device``:
    ``"device"`` (NCCL on the card; gloo on the CPU) or ``"host"`` (gloo
    with CUDA tensors: a copy to the host and back around the call). Fixed
    by the group's backend, never by a failure."""
    backend = (dist.get_backend(axis.group) if axis.group is not None
               else dist.get_backend())
    if torch.device(device).type == "cuda" and backend == "gloo":
        return "host"
    return "device"


class ExchangePlan(NamedTuple):
    """Static-shape routing of one table's row exchange, built each step
    from the (model-replicated) plan. ``reqs`` pads each owner's bucket to
    the slice capacity C = ceil(U / D) with the fill id ``num_rows``, which
    owners answer with zero rows.

    reqs:     int32 [D, C]  row ids this peer requests from each owner.
    flat_idx: int64 [C]     position in the flattened [D*C] response block
                            of each of this peer's uid slots; D*C (reads
                            zero) for fill slots.
    num_rows: int           global rows of the table (the fill id).
    rows_local: int         rows per shard.
    num_shards: int         D, the model axis.
    n_ids: int              U, the plan's uid slots.
    shard: int              this peer's shard index.
    """
    reqs: torch.Tensor
    flat_idx: torch.Tensor
    num_rows: int
    rows_local: int
    num_shards: int
    n_ids: int
    shard: int


def build_exchange(entry: PlanEntry, num_shards: int,
                   shard: int) -> ExchangePlan:
    """Bucket this peer's slice of the uid slots (C of them, slice
    ``shard``) by owner shard: the uids are sorted, so each owner's run is
    contiguous and two ``searchsorted`` bounds find it. No communication:
    every peer holds the same plan."""
    if entry.num_rows % num_shards:
        raise ValueError(f"table rows {entry.num_rows} not divisible by "
                         f"{num_shards} shards")
    uids = entry.uids.to(torch.int32)
    dev = uids.device
    n = uids.shape[0]
    d = num_shards
    rows_local = entry.num_rows // d
    cap = -(-n // d)
    pad = torch.full((d * cap - n,), entry.num_rows, dtype=torch.int32,
                     device=dev)
    sl = torch.cat([uids, pad])[shard * cap:(shard + 1) * cap]
    bounds = torch.searchsorted(
        sl, torch.arange(d + 1, dtype=torch.int32, device=dev) * rows_local,
        side="left", out_int32=True)
    starts, ends = bounds[:-1], bounds[1:]
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    idx = starts[:, None] + slot[None, :]
    fill = torch.full((), entry.num_rows, dtype=torch.int32, device=dev)
    reqs = torch.where(idx < ends[:, None],
                       sl[torch.clamp(idx, 0, cap - 1).long()], fill)
    owner = torch.div(sl, rows_local, rounding_mode="floor")
    rank = slot - starts[torch.clamp(owner, 0, d - 1).long()]
    flat_idx = torch.where(owner < d, owner * cap + rank,
                           torch.full((), d * cap, dtype=torch.int32,
                                      device=dev)).long()
    return ExchangePlan(reqs=reqs, flat_idx=flat_idx,
                        num_rows=entry.num_rows, rows_local=rows_local,
                        num_shards=d, n_ids=n, shard=shard)


@torch.no_grad()
def exchange_rows(local_table: torch.Tensor, ex: ExchangePlan,
                  axis: ModelAxis) -> torch.Tensor:
    """Gather ``ex``'s uid rows from a row-sharded table: all_to_all the
    requests, answer from the owned rows (other ids read zero), all_to_all
    the answers back, place this peer's slice and sum the peers' slices
    with one all_reduce. Returns [U, ...] equal to :func:`gather_rows` on
    the full table bit for bit."""
    d, cap = ex.num_shards, ex.reqs.shape[1]
    tail = tuple(local_table.shape[1:])
    recv = _all_to_all(ex.reqs.reshape(-1), axis)
    local = recv.long() - ex.shard * ex.rows_local
    ok = (local >= 0) & (local < ex.rows_local)
    safe = torch.where(ok, local, torch.zeros_like(local))
    zero = torch.zeros((), dtype=local_table.dtype,
                       device=local_table.device)
    resp = torch.where(trailing_dims(ok, 1 + len(tail)),
                       local_table.index_select(0, safe), zero)
    got = _all_to_all(resp, axis)
    hit = ex.flat_idx < d * cap
    mine = torch.where(trailing_dims(hit, 1 + len(tail)), got.index_select(
        0, torch.where(hit, ex.flat_idx, torch.zeros_like(ex.flat_idx))),
        zero)
    full = torch.zeros((d * cap,) + tail, dtype=local_table.dtype,
                       device=local_table.device)
    full[ex.shard * cap:(ex.shard + 1) * cap] = mine
    dist.all_reduce(full, group=axis.group)
    return full[:ex.n_ids]


@torch.no_grad()
def owner_scatter_add(g_rows: torch.Tensor, entry: PlanEntry,
                      num_shards: int, shard: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-uid cotangents into this shard's table space: (grad
    [rows_local, ...], touched bool [rows_local]). Ids another shard owns
    and the plan's fill slots go to the sentinel row ``rows_local``, which
    is cut off. The real uids are distinct, so each kept row has one
    contributor and ``index_add_`` (0.0 + g) is exact in any order."""
    rows_local = entry.num_rows // num_shards
    local = entry.uids.long() - shard * rows_local
    owned = (local >= 0) & (local < rows_local) & valid_rows(entry)
    safe = torch.where(owned, local, torch.full_like(local, rows_local))
    grad = torch.zeros((rows_local + 1,) + tuple(g_rows.shape[1:]),
                       dtype=g_rows.dtype, device=g_rows.device)
    grad.index_add_(0, safe, g_rows)
    touched = torch.zeros(rows_local + 1, dtype=torch.bool,
                          device=g_rows.device)
    touched[safe] = True
    return grad[:rows_local], touched[:rows_local]


def exchange_payload_bytes(n_ids: int, row_elems: int, num_shards: int,
                           itemsize: int = 4) -> int:
    """Per-device bytes of one table's forward exchange (the JAX
    package's formula): the request all_to_all (D*C int32 ids), the
    response all_to_all (D*C rows) and the all_reduce's reassembly buffer
    (D*C rows; a ring moves about 2(D-1)/D of it), C = ceil(n_ids / D).
    Zero unsharded."""
    if num_shards <= 1:
        return 0
    cap = -(-n_ids // num_shards)
    block = num_shards * cap
    return block * 4 + 2 * block * row_elems * itemsize
