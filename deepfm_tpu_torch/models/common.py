"""Shared model building blocks (port of ``deepfm_tpu.models.common``):
initializers, the DNN tower with BN and dropout, the l2 terms and the
embedding layouts, monolithic and hash-bucketed, with the sparse update's
plan and row operations and the lookups of tables row-sharded over a model
axis.

Behavioral parity with the JAX package:
  * Hidden layers: dense -> ReLU -> [BatchNorm] -> [dropout]. BN runs in
    float32, from batch statistics in train mode and running statistics in
    eval mode (see :func:`batch_norm`); under data parallelism
    (:func:`cross_replica_bn`) the batch statistics are averaged over the
    data ranks, forward and backward. ``dropout`` values are KEEP
    probabilities, applied in train mode only; the masks come from an
    explicit ``torch.Generator`` and so differ from ``jax.random``'s bits.
  * Tower weights keep the JAX layout, ``w`` is ``[d_in, d_out]`` applied
    as ``x @ w``, so a JAX param tree carries over without transposes
    (``utils.params.params_from_jax``).
  * Matmuls run in ``compute_dtype`` (bfloat16 by default) over float32
    params, rounding where the JAX package rounds: after each product and
    again after each bias add.
  * Every ``[d, 1]`` head (the tower's output, DCN-v2's combination
    head, the multi-task heads, DIN's score layer) is computed as a
    row-wise float32 dot product rounded to ``compute_dtype``
    (:func:`dense_head`): the same value as the JAX
    ``h @ w`` up to summation order, and independent of the batch size,
    so a padded serving bucket returns bit-identical real rows (BLAS picks
    a matrix-vector kernel whose sum order depends on the row count).

Initializers draw from an explicit ``torch.Generator``; they give other
numbers than ``jax.random`` for the same seed, so tests carry JAX weights
over instead of comparing inits.
"""

from __future__ import annotations

import contextlib
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn

from ..obs import trace as trace_lib
from ..ops import embedding as emb_ops
from ..ops import embedding_kernels as ek


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    recep = 1
    for s in shape[:-2]:
        recep *= s
    return shape[-2] * recep, shape[-1] * recep


def _draw(fill, shape: Sequence[int], generator: Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """float32 tensor of ``shape`` on ``device``, drawn on the generator's
    device. On the ``meta`` device nothing is drawn (weights come from a
    later ``load_state_dict(..., assign=True)``)."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if generator is None:
        raise ValueError("initializing weights needs a torch.Generator")
    out = torch.empty(tuple(shape), dtype=torch.float32,
                      device=generator.device)
    fill(out, generator)
    return out.to(device)


def glorot_normal(shape: Sequence[int], *,
                  generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return _draw(lambda t, g: t.normal_(0.0, std, generator=g),
                 shape, generator, device)


def glorot_uniform(shape: Sequence[int], *,
                   generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return _draw(lambda t, g: t.uniform_(-limit, limit, generator=g),
                 shape, generator, device)


# ---------------------------------------------------------------------------
# BatchNorm (running-stats state)
# ---------------------------------------------------------------------------


# The data axis of a training forward under data parallelism: (world size,
# process group), set by :func:`cross_replica_bn` around the forward.
_BN_DATA_AXIS: Optional[Tuple[int, Any]] = None


@contextlib.contextmanager
def cross_replica_bn(world: int, group: Any = None) -> Iterator[None]:
    """Train-mode BN inside the block takes its batch statistics over the
    ``world`` data ranks of ``group`` (the JAX ``pmean`` over ``'data'``)."""
    global _BN_DATA_AXIS
    prev = _BN_DATA_AXIS
    _BN_DATA_AXIS = (world, group) if world > 1 else None
    try:
        yield
    finally:
        _BN_DATA_AXIS = prev


def _pmean_stats(mean: torch.Tensor, mean_sq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data ranks' average of (E[x], E[x^2]) in ONE all_reduce that
    autograd differentiates: its backward all-reduces the incoming
    gradient, so rank r's local statistics receive the sum over ranks of
    their share, and the averaged parameter gradient of N ranks at B/N rows
    equals one device's at B rows."""
    from torch.distributed.nn import functional as dist_fn  # noqa: PLC0415
    world, group = _BN_DATA_AXIS
    both = dist_fn.all_reduce(torch.stack([mean, mean_sq]),
                              group=group if group is not None
                              else torch.distributed.group.WORLD)
    both = both / world
    return both[0], both[1]


def batch_norm(h32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               stats: "RunningStats", *, train: bool, decay: float,
               eps: float = 1e-3) -> torch.Tensor:
    """Normalize h32 [B, D] (float32).

    Eval mode uses the running statistics. Train mode uses the batch's
    statistics with ``var = E[x^2] - E[x]^2`` (the biased variance) and
    blends them into the running statistics in place, ``decay`` parts old
    to ``1 - decay`` parts new: what ``deepfm_tpu.models.common.batch_norm``
    returns as the new model state. ``nn.BatchNorm1d`` differs on both counts
    (unbiased running variance, ``momentum = 1 - decay``). Inside
    :func:`cross_replica_bn` E[x] and E[x^2] are averaged over the data
    ranks first, so every rank blends the same statistics."""
    if train:
        mean = torch.mean(h32, dim=0)
        mean_sq = torch.mean(h32 * h32, dim=0)
        if _BN_DATA_AXIS is not None:
            mean, mean_sq = _pmean_stats(mean, mean_sq)
        var = mean_sq - mean * mean
        with torch.no_grad():
            stats.mean.copy_(decay * stats.mean + (1 - decay) * mean)
            stats.var.copy_(decay * stats.var + (1 - decay) * var)
    else:
        mean, var = stats.mean, stats.var
    return (h32 - mean) * torch.rsqrt(var + eps) * scale + bias


class RunningStats(nn.Module):
    """One BN layer's running statistics: the model state ``bn[i]``."""

    def __init__(self, dim: int, *, device: torch.device):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))


# ---------------------------------------------------------------------------
# DNN tower
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """One tower layer: ``w`` [d_in, d_out], ``b`` [d_out] and, with BN,
    ``bn_scale``/``bn_bias`` [d_out]."""

    def __init__(self, d_in: int, d_out: int, *, use_bn: bool,
                 generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(glorot_uniform((d_in, d_out),
                                             generator=generator,
                                             device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))
        if use_bn:
            self.bn_scale = nn.Parameter(torch.ones(d_out, device=device))
            self.bn_bias = nn.Parameter(torch.zeros(d_out, device=device))


class Tower(nn.Module):
    """Hidden stack (``layers``) plus the dense->1 head (``out``)."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int], *,
                 use_bn: bool, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        dims = [in_dim] + list(layer_sizes)
        self.layers = nn.ModuleList(
            Dense(d_in, d_out, use_bn=use_bn, generator=generator,
                  device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        self.out = Dense(dims[-1], 1, use_bn=False, generator=generator,
                         device=device)


def init_tower(in_dim: int, layer_sizes: Sequence[int], use_bn: bool, *,
               generator: Optional[torch.Generator],
               device: torch.device) -> Tuple[Tower, nn.ModuleList]:
    """Hidden stack + final dense->1. Returns (tower, bn running stats)."""
    tower = Tower(in_dim, layer_sizes, use_bn=use_bn, generator=generator,
                  device=device)
    return tower, _running_stats(layer_sizes, use_bn, device)


def _running_stats(layer_sizes: Sequence[int], use_bn: bool,
                   device: torch.device) -> nn.ModuleList:
    return nn.ModuleList(RunningStats(d, device=device) for d in layer_sizes
                         ) if use_bn else nn.ModuleList()


class Stack(nn.Module):
    """A hidden stack that carries its own BN running statistics, with the
    tower's dense->1 head when ``head``: one JAX ``(params, state)`` pair,
    params ``{"layers": [...][, "out": {...}]}`` and state ``{"bn":
    [...]}``, so its names (``layers.<i>.w``, ``out.w``, ``bn.<i>.mean``)
    are the flattened JAX trees under the owner's key (the multi-task
    bottom, experts and towers)."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int], *,
                 use_bn: bool, head: bool,
                 generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        dims = [in_dim] + list(layer_sizes)
        self.layers = nn.ModuleList(
            Dense(d_in, d_out, use_bn=use_bn, generator=generator,
                  device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        if head:
            self.out = Dense(dims[-1], 1, use_bn=False, generator=generator,
                             device=device)
        self.bn = _running_stats(layer_sizes, use_bn, device)


def dropout(h: torch.Tensor, keep: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with a KEEP probability: ``where(mask, h/keep, 0)``
    in ``h``'s dtype, the mask drawn from ``generator``."""
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                   device=h.device))


def apply_hidden_stack(layers: nn.ModuleList, bn: nn.ModuleList,
                       x: torch.Tensor, *, train: bool,
                       dropout_keep: Sequence[float], use_bn: bool,
                       bn_decay: float, generator: Optional[torch.Generator],
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """dense->relu->[BN]->[dropout] stack. x: [B, D_in] -> [B, D_last].

    Dropout runs in train mode only, and only with a ``generator``."""
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer.w.to(compute_dtype) + layer.b.to(compute_dtype)
        h = torch.relu(h)
        if use_bn:
            h = batch_norm(h.float(), layer.bn_scale, layer.bn_bias, bn[i],
                           train=train, decay=bn_decay).to(compute_dtype)
        keep = dropout_keep[i] if i < len(dropout_keep) else 1.0
        if train and keep < 1.0 and generator is not None:
            h = dropout(h, keep, generator)
    return h


def apply_tower(tower: Tower, bn: nn.ModuleList, x: torch.Tensor, *,
                train: bool, dropout_keep: Sequence[float], use_bn: bool,
                bn_decay: float, generator: Optional[torch.Generator],
                compute_dtype: torch.dtype) -> torch.Tensor:
    """Hidden stack + output head. x: [B, D] -> [B] float32."""
    h = apply_hidden_stack(tower.layers, bn, x, train=train,
                           dropout_keep=dropout_keep, use_bn=use_bn,
                           bn_decay=bn_decay, generator=generator,
                           compute_dtype=compute_dtype)
    return dense_head(h, tower.out.w, tower.out.b)


def dense_head(h: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """A ``[d, 1]`` head ``h @ w + b`` in ``h``'s dtype -> float32 [...]:
    a row-wise float32 dot product of ``h`` with ``w`` cast to ``h``'s
    dtype, rounded to it, plus the bias in it. Independent of the row
    count, so padded serving buckets return bit-identical real rows
    (BLAS's matrix-vector kernel sums in a batch-dependent order)."""
    cdt = h.dtype
    out = torch.sum(h.float() * w[:, 0].to(cdt).float(), dim=-1).to(cdt)
    return (out + b[0].to(cdt)).float()


def narrow_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a narrow ``w`` [d, n] (MMoE's gates: n = experts) in
    ``h``'s dtype: per-row float32 dot products rounded to it, like
    :func:`dense_head`, so the result does not depend on the row count."""
    cdt = h.dtype
    return torch.sum(h.float().unsqueeze(-1) * w.to(cdt).float(),
                     dim=-2).to(cdt)


def l2_half_sum(x: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_loss semantics: 0.5 * sum(x^2)."""
    x = x.float()
    return 0.5 * torch.sum(x * x)


# ---------------------------------------------------------------------------
# Embedding schema: monolithic vs hash-bucketed multi-table layout
# ---------------------------------------------------------------------------

Entry = Union[torch.Tensor, Dict[str, torch.Tensor]]
Plan = Dict[str, emb_ops.PlanEntry]
# A batch's dense gather ids: monolithic (with the in-range marks), the
# hashed tables' buckets, or either as a row shard reads them.
DenseIndex = Union[emb_ops.DenseIds, ek.SharedSegments, emb_ops.ShardedIds,
                   "ShardedBuckets"]


class ShardedBuckets:
    """The hashed tables' buckets as a row shard reads them: each bucket in
    its table's local rows (0 where another shard owns it), ``mine`` [T,
    ...] marking the owned ones, whose positions alone enter the segments."""

    def __init__(self, local: torch.Tensor, mine: torch.Tensor,
                 rows_local: List[int]):
        self.mine = mine
        self.shared = ek.SharedSegments(
            local.reshape(len(rows_local), -1), rows_local,
            keep=mine.reshape(len(rows_local), -1))


class EmbeddingSchema:
    """The embedding-table layout resolved from cfg, and every operation the
    model and the trainer perform on it (``deepfm_tpu.models.common.
    EmbeddingSchema`` on one device).

    * **monolithic** (``embedding_buckets`` empty): one ``[padded_vocab,
      ...]`` table per embedding param.
    * **hashed** (``embedding_buckets`` set): tables ``{"t0": [B0, ...],
      ...}`` per param; each id picks a table (by id hash or by field) and a
      bucket in it by stateless uint32 mixing (``ops.embedding.
      hash_bucket``), so the logical ``feature_size`` may exceed any one
      table.
    * **per-feature** (``table_rows`` set, ``--model dlrm_dcnv2``): tables
      ``{"t0": [R0, ...], ...}``, one per sparse feature. Feature f's ids
      fill its own span of ``feat_ids``' columns (``hotness[f]`` wide,
      after the dense columns) and are rows of table f, in [0, R_f); each
      feature's bag is summed (:meth:`pool`, :meth:`pool_rows`). No pad
      rows, as in the hashed layout.

    Under a model axis (an ``axis``, :class:`ops.embedding.ModelAxis`) an
    entry holds this rank's rows of each table: :meth:`lookup` reads the
    owned ids and sums the peers' parts (monolithic: ``--embedding_lookup
    masked_psum`` or ``allgather_table``; hashed: one sum for every
    table), and :meth:`l2` / :meth:`mask_pad_grads` take the shard's global
    row ``offset``. Table shapes never depend on the mesh
    (``padded_vocab``).

    An *entry* is one param's table (monolithic) or dict of tables
    (hashed, per-feature). In the model's flat state those tables are named
    ``"<param>.<key>"`` (``fm_v.t0``), as ``params_from_jax`` flattens the
    JAX tree. The sparse update speaks :class:`ops.embedding.PlanEntry` per
    table key (``"table"`` when monolithic).
    """

    #: plan/rows dict key for the monolithic table
    MONO = "table"

    def __init__(self, cfg):
        self.feature_size = int(cfg.feature_size)
        self.buckets: List[int] = list(cfg.embedding_bucket_sizes)
        self.hashed = bool(self.buckets)
        self.feature_rows: List[int] = list(cfg.table_row_counts)
        self.per_feature = bool(self.feature_rows)
        self.hotness: List[int] = list(cfg.feature_hotness_values)
        # Feature f's columns of feat_ids: [starts[f], starts[f + 1]).
        self.starts = [cfg.field_size - sum(self.hotness)]
        for h in self.hotness:
            self.starts.append(self.starts[-1] + h)
        # (slots, rows, device) -> arange(slots) % rows (spread_index).
        self._spreads: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}
        self.assign = cfg.embedding_assign
        self.kernels = cfg.embedding_kernels
        self.lookup_strategy = cfg.embedding_lookup
        self.padded_vocab = emb_ops.padded_vocab(cfg.feature_size,
                                                 cfg.mesh_model)
        # --embedding_shard rows: the sparse row plane's shard count (1:
        # every rank holds whole tables). The dense update's model axis
        # shards the tables too; its lookups read the shard from ``axis``.
        self.num_shards = (max(int(cfg.mesh_model), 1)
                           if cfg.embedding_shard == "rows" else 1)

    # -- layout ---------------------------------------------------------
    @property
    def monolithic(self) -> bool:
        return not (self.hashed or self.per_feature)

    def _table_sizes(self) -> List[int]:
        return self.feature_rows if self.per_feature else self.buckets

    def table_keys(self) -> List[str]:
        if self.monolithic:
            return [self.MONO]
        return [f"t{i}" for i in range(len(self._table_sizes()))]

    def table_rows(self, key: str) -> int:
        """Row count of one physical table."""
        if self.monolithic:
            return self.padded_vocab
        return self._table_sizes()[int(key[1:])]

    def num_physical_rows(self) -> int:
        """Rows actually allocated (vs the logical feature_size)."""
        return self.padded_vocab if self.monolithic else sum(
            self._table_sizes())

    def param_key(self, name: str, key: str) -> str:
        """Flat state name of one table of param ``name``."""
        return name if self.monolithic else f"{name}.{key}"

    def entry(self, params: Mapping[str, torch.Tensor], name: str) -> Entry:
        """Param ``name``'s entry out of a flat ``{name: tensor}`` state."""
        if self.monolithic:
            return params[name]
        return {k: params[self.param_key(name, k)] for k in self.table_keys()}

    def init_entry(self, trailing: Tuple[int, ...], *,
                   generator: Optional[torch.Generator],
                   device: torch.device) -> Entry:
        """Glorot-normal tables. Monolithic: over the REAL vocab, zero pad
        rows after it. Hashed and per-feature: one glorot table per bucket
        or row count, drawn in table order from ``generator``."""
        if not self.monolithic:
            return {f"t{i}": glorot_normal((b, *trailing),
                                           generator=generator, device=device)
                    for i, b in enumerate(self._table_sizes())}
        t = glorot_normal((self.feature_size, *trailing),
                          generator=generator, device=device)
        pad = self.padded_vocab - self.feature_size
        if pad:
            # A slice copy, not torch.cat: cat's meta kernel (the trainer
            # builds its template on meta) imports torch._dynamo, seconds
            # of every launcher process's start.
            full = torch.zeros((self.padded_vocab, *trailing), dtype=t.dtype,
                               device=device)
            full[:self.feature_size] = t
            t = full
        return t

    def tables(self, entry: Entry) -> Dict[str, torch.Tensor]:
        """Uniform dict view of an entry: {key: [rows, ...] table}."""
        return {self.MONO: entry} if self.monolithic else entry

    def from_tables(self, tables: Dict[str, torch.Tensor]) -> Entry:
        return tables[self.MONO] if self.monolithic else tables

    # -- id -> (table, bucket) mapping ---------------------------------
    def _table_of(self, feat_ids: torch.Tensor) -> torch.Tensor:
        n = len(self.buckets)
        if self.assign == "field":
            f = torch.arange(feat_ids.shape[-1], dtype=torch.int32,
                             device=feat_ids.device) % n
            return f.expand(feat_ids.shape)
        return emb_ops.hash_table_assign(feat_ids, n)

    # -- dense forward --------------------------------------------------
    def dense_index(self, feat_ids: torch.Tensor, entry: Entry,
                    axis: Optional[emb_ops.ModelAxis] = None) -> DenseIndex:
        """One batch's gather ids into tables shaped like ``entry``'s,
        shared by every embedding name's :meth:`lookup` of the batch, so
        the backward builds their position segments once (one launch for
        all hashed tables on the card). Under ``axis`` ``entry`` holds
        this rank's rows."""
        if not self.hashed:
            rows = entry.shape[0]
            if axis is None:
                return emb_ops.dense_ids(feat_ids, rows)
            if self.lookup_strategy == "allgather_table":
                return emb_ops.dense_ids(feat_ids, rows * axis.size)
            return emb_ops.sharded_ids(feat_ids, rows, axis)
        keys = self.table_keys()
        ids = torch.stack([emb_ops.hash_bucket(feat_ids, b, salt=i + 1)
                           .reshape(-1) for i, b in enumerate(self.buckets)
                           ]).long()
        rows = [entry[k].shape[0] for k in keys]
        if axis is None:
            return ek.SharedSegments(ids, rows)
        local = ids - axis.index * torch.tensor(
            rows, dtype=ids.dtype, device=ids.device)[:, None]
        rl = torch.tensor(rows, dtype=ids.dtype, device=ids.device)[:, None]
        mine = (local >= 0) & (local < rl)
        return ShardedBuckets(torch.where(mine, local, torch.zeros_like(
            local)), mine, rows)

    def lookup(self, entry: Entry, feat_ids: torch.Tensor,
               index: Optional[DenseIndex] = None,
               axis: Optional[emb_ops.ModelAxis] = None) -> torch.Tensor:
        """[B,F,*trailing] gather (the dense path, eval and serving), at
        ``index`` (:meth:`dense_index` of ``feat_ids``, built here when
        None). The hashed parts are summed in table order t0, t1, ..., as
        the JAX package sums them; under ``axis`` each part is this
        shard's owned buckets and ONE sum over the peers reassembles every
        table's at once. (Per-feature tables are read by :meth:`pool`.)"""
        if index is None:
            index = self.dense_index(feat_ids, entry, axis)
        if not self.hashed:
            if axis is None:
                return emb_ops.lookup(entry, feat_ids, index)
            if self.lookup_strategy == "allgather_table":
                return emb_ops.sharded_lookup_allgather(entry, feat_ids,
                                                        axis, index)
            return emb_ops.sharded_lookup(entry, feat_ids, axis, index)
        table_of = self._table_of(feat_ids)
        shared = index.shared if axis is not None else index
        out = None
        for i in range(len(self.buckets)):
            tab = entry[f"t{i}"]
            part = shared.rows(tab, i).reshape(
                tuple(feat_ids.shape) + tuple(tab.shape[1:]))
            if axis is not None:
                part = torch.where(emb_ops.trailing_dims(
                    index.mine[i].reshape(feat_ids.shape), part.dim()),
                    part, torch.zeros((), dtype=part.dtype,
                                      device=part.device))
            sel = emb_ops.trailing_dims((table_of == i).to(part.dtype),
                                        part.dim())
            part = part * sel
            out = part if out is None else out + part
        if axis is not None:
            out = emb_ops.sum_over_peers(out, axis)
        return out

    # -- sparse-update plan ---------------------------------------------
    def sparse_plan(self, feat_ids: torch.Tensor,
                    num_rows: Optional[int] = None) -> Plan:
        """One batch's dedup plan per table, through the
        ``embedding_kernels`` plan leg. ``num_rows`` overrides the
        monolithic fill id. The hashed tables' ids are built stacked,
        ``[T, B, F]``; on the kernel leg one plan launch serves up to
        ``ek.MAX_TABLES`` of them. On the card, when the take leg is the
        kernel, each entry also carries its position segments, every
        table's built by one segments launch here
        (``ek.position_segments_tables``) and shared by every embedding
        name's backward."""
        with_segments = feat_ids.device.type == "cuda" and ek.resolve(
            self.kernels, "take") == "kernel"
        if self.per_feature:
            return self._feature_plan(feat_ids, with_segments)
        if not self.hashed:
            rows = self.padded_vocab if num_rows is None else int(num_rows)
            plan = {self.MONO: ek.plan_build(feat_ids, rows,
                                             mode=self.kernels)}
            if with_segments:
                e = plan[self.MONO]
                plan[self.MONO] = e._replace(segments=ek.position_segments(
                    e.inv, e.uids.shape[0]))
        else:
            table_of = self._table_of(feat_ids)
            shape = (len(self.buckets),) + tuple(feat_ids.shape)
            ids = torch.empty(shape, dtype=torch.int32,
                              device=feat_ids.device)
            sel = torch.empty(shape, dtype=torch.bool,
                              device=feat_ids.device)
            for i, b in enumerate(self.buckets):
                bucket = emb_ops.hash_bucket(feat_ids, b, salt=i + 1)
                torch.eq(table_of, i, out=sel[i])
                torch.where(sel[i], bucket, torch.full(
                    (), b, dtype=torch.int32, device=bucket.device),
                    out=ids[i])
            masks = list(sel.float())
            keys = self.table_keys()
            if all(ek.resolve(self.kernels, "plan", num_rows=b) == "kernel"
                   for b in self.buckets):
                entries = []
                for s in range(0, len(keys), ek.MAX_TABLES):
                    part = slice(s, s + ek.MAX_TABLES)
                    entries += ek.plan_build_tables(
                        ids[part], self.buckets[part], masks[part])
            else:
                entries = [ek.plan_build(ids[i], b, mask=masks[i],
                                         mode=self.kernels)
                           for i, b in enumerate(self.buckets)]
            if with_segments:
                n = ids[0].numel()
                inv = torch.stack([e.inv.reshape(-1) for e in entries])
                entries = [e._replace(segments=s) for e, s in zip(
                    entries, ek.position_segments_tables(
                        inv, n, sel.reshape(len(entries), n)))]
            plan = dict(zip(keys, entries))
        return plan

    def num_lookups(self, feat_ids: torch.Tensor) -> int:
        """Ids of the batch that read a table: every column's, but the
        dense columns' in the per-feature layout."""
        if self.per_feature:
            return int(feat_ids.shape[0]) * sum(self.hotness)
        return int(feat_ids.numel())

    def feature_ids(self, feat_ids: torch.Tensor, f: int) -> torch.Tensor:
        """Feature ``f``'s bag ids [B, hotness[f]]: rows of table f."""
        return feat_ids[:, self.starts[f]:self.starts[f + 1]]

    def _feature_groups(self, legs: Sequence[str]) -> List[List[int]]:
        """The features in groups that one launch can serve: equal hotness
        (one id count N) and leg, at most ``ek.MAX_TABLES`` a group."""
        by: Dict[Tuple[int, str], List[int]] = {}
        for f, (h, leg) in enumerate(zip(self.hotness, legs)):
            by.setdefault((h, leg), []).append(f)
        return [fs[s:s + ek.MAX_TABLES] for fs in by.values()
                for s in range(0, len(fs), ek.MAX_TABLES)]

    def _feature_plan(self, feat_ids: torch.Tensor,
                      with_segments: bool) -> Plan:
        """One plan per feature over its bag's ids, table by table, on the
        leg ``ek.resolve`` picks for its rows. The kernel leg builds one
        launch for each group of equal hotness; the other legs build table
        by table (``ek.plan_build``). The position segments follow
        (``with_segments``), one launch for each group of equal hotness,
        whatever its leg."""
        legs = [ek.resolve(self.kernels, "plan", num_rows=r)
                for r in self.feature_rows]
        entries: List[Optional[emb_ops.PlanEntry]] = [None] * len(legs)
        for f, leg in enumerate(legs):
            if leg != "kernel":
                entries[f] = ek.plan_build(self.feature_ids(feat_ids, f),
                                           self.feature_rows[f],
                                           mode=self.kernels)
        for group in self._feature_groups(legs):
            if legs[group[0]] != "kernel":
                continue
            ids = torch.stack([self.feature_ids(feat_ids, f) for f in group])
            built = ek.plan_build_tables(
                ids, [self.feature_rows[f] for f in group])
            for f, e in zip(group, built):
                entries[f] = e
        if with_segments:
            for group in self._feature_groups(["any"] * len(legs)):
                inv = torch.stack([entries[f].inv.reshape(-1)
                                   for f in group])
                segs = ek.position_segments_tables(
                    inv, [entries[f].uids.shape[0] for f in group])
                for f, seg in zip(group, segs):
                    entries[f] = entries[f]._replace(segments=seg)
        return dict(zip(self.table_keys(), entries))

    def pool(self, entry: Entry, feat_ids: torch.Tensor) -> torch.Tensor:
        """Per-feature layout, the dense path: every feature's bag summed
        from its table, [B, T, *trailing] (the lookups' gradient flows to
        the tables)."""
        parts = [emb_ops.lookup(entry[k], self.feature_ids(feat_ids, f))
                 for f, k in enumerate(self.table_keys())]
        with trace_lib.span("embed.pool", device=feat_ids.device):
            return torch.stack([p.sum(dim=1) for p in parts], dim=1)

    def pool_rows(self, rows: Dict[str, torch.Tensor],
                  plan: Plan) -> torch.Tensor:
        """Per-feature layout, the sparse update: every feature's bag
        summed from its pre-gathered rows, [B, T, *trailing]. Each view is
        one take (the kernel leg on the card: one take forward, and one
        take backward over the plan's segments)."""
        parts = [emb_ops.lookup_rows(rows[k], e, mode=self.kernels)
                 for k, e in plan.items()]
        with trace_lib.span("embed.pool", device=parts[0].device):
            return torch.stack([p.sum(dim=1) for p in parts], dim=1)

    def spread_index(self, plan: Plan) -> Dict[str, torch.Tensor]:
        """``ops.embedding.spread_index`` of every table's plan, each
        table's spread (slot s -> s mod rows) made once."""
        out = {}
        for k, e in plan.items():
            n, dev = e.uids.shape[0], e.uids.device
            spread = self._spreads.get((n, e.num_rows, dev))
            if spread is None:
                spread = torch.remainder(torch.arange(
                    n, dtype=torch.int32, device=dev), e.num_rows)
                self._spreads[(n, e.num_rows, dev)] = spread
            out[k] = emb_ops.spread_index(e, spread)
        return out

    def gather_rows(self, entry: Entry, plan: Plan,
                    index: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Touched rows per table: the sparse path's gradient leaf. Fill
        slots read zero, or, at an ``index`` per table
        (``ops.embedding.spread_index``), real rows that no position
        reads."""
        tabs = self.tables(entry)
        if index is not None:
            return {k: tabs[k].index_select(0, index[k]) for k in plan}
        return {k: emb_ops.gather_rows(tabs[k], plan[k]) for k in plan}

    def lookup_rows(self, rows: Dict[str, torch.Tensor],
                    plan: Optional[Plan]) -> torch.Tensor:
        """[B,F,*trailing] view over pre-gathered rows, the parts summed in
        plan key order. On the kernel leg one fused take serves every
        table (up to ``ek.MAX_TABLES``): gather, mask and sum in one
        launch. With ``plan`` None the rows are already the [B,F,...]
        batch view (the fused backward's leaves)."""
        if plan is None:
            assert len(rows) == 1
            return next(iter(rows.values()))
        if (ek.resolve(self.kernels, "take") == "kernel"
                and len(plan) <= ek.MAX_TABLES):
            entries = list(plan.values())
            masks = None if entries[0].mask is None else [
                e.mask for e in entries]
            return ek.take_rows_sum([rows[k] for k in plan],
                                    [e.inv for e in entries], masks,
                                    [e.segments for e in entries])
        out = None
        for k in plan:
            part = emb_ops.lookup_rows(rows[k], plan[k], mode=self.kernels)
            out = part if out is None else out + part
        return out

    # -- regularization -------------------------------------------------
    def l2(self, entry: Entry, offset: int = 0) -> torch.Tensor:
        """0.5*sum(x^2) over REAL rows: monolithic pad rows are masked out,
        so their gradient is exactly zero by construction; hashed tables
        have no pad rows and are summed table by table. ``offset``: the
        global row of a shard's first row (this shard's part only; the
        caller sums the peers')."""
        if not self.monolithic:
            return sum(l2_half_sum(t) for t in entry.values())
        return l2_half_sum(emb_ops.mask_pad_rows(entry, self.feature_size,
                                                 offset))

    def l2_rows(self, rows: Dict[str, torch.Tensor],
                plan: Plan) -> torch.Tensor:
        """Sparse-mode L2 over the batch's TOUCHED rows only (fill slots
        excluded): idle rows do not decay between touches."""
        total = None
        for k, entry in plan.items():
            x = rows[k].float()
            valid = emb_ops.trailing_dims(emb_ops.valid_rows(entry).float(),
                                          x.dim())
            s = 0.5 * torch.sum(x * x * valid)
            total = s if total is None else total + s
        return total

    def mask_pad_grads(self, grad_entry: torch.Tensor,
                       offset: int = 0) -> torch.Tensor:
        """Zero pad-row gradients on the dense path (hashed and per-feature
        tables have no pad rows: the identity); ``offset`` as in
        :meth:`l2`."""
        if not self.monolithic:
            return grad_entry
        return emb_ops.mask_pad_rows(grad_entry, self.feature_size, offset)
