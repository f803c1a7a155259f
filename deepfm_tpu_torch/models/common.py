"""Shared model building blocks (the single-device subset of
``deepfm_tpu.models.common``): initializers, the DNN tower with BN and
dropout, the l2 terms and the embedding layouts, monolithic and
hash-bucketed, with the sparse update's plan and row operations.

Behavioral parity with the JAX package:
  * Hidden layers: dense -> ReLU -> [BatchNorm] -> [dropout]. BN runs in
    float32, from batch statistics in train mode and running statistics in
    eval mode (see :func:`batch_norm`). ``dropout`` values are KEEP
    probabilities, applied in train mode only; the masks come from an
    explicit ``torch.Generator`` and so differ from ``jax.random``'s bits.
  * Tower weights keep the JAX layout, ``w`` is ``[d_in, d_out]`` applied
    as ``x @ w``, so a JAX param tree carries over without transposes
    (``utils.params.params_from_jax``).
  * Matmuls run in ``compute_dtype`` (bfloat16 by default) over float32
    params, rounding where the JAX package rounds: after each product and
    again after each bias add.
  * The output head (``[d, 1]``) is computed as a row-wise float32 dot
    product rounded to ``compute_dtype``: the same value as the JAX
    ``h @ w`` up to summation order, and independent of the batch size,
    so a padded serving bucket returns bit-identical real rows (BLAS picks
    a matrix-vector kernel whose sum order depends on the row count).

Initializers draw from an explicit ``torch.Generator``; they give other
numbers than ``jax.random`` for the same seed, so tests carry JAX weights
over instead of comparing inits.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

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


def batch_norm(h32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               stats: "RunningStats", *, train: bool, decay: float,
               eps: float = 1e-3) -> torch.Tensor:
    """Normalize h32 [B, D] (float32).

    Eval mode uses the running statistics. Train mode uses the batch's
    statistics with ``var = E[x^2] - E[x]^2`` (the biased variance) and
    blends them into the running statistics in place, ``decay`` parts old
    to ``1 - decay`` parts new: what ``deepfm_tpu.models.common.batch_norm``
    returns as the new model state. ``nn.BatchNorm1d`` differs on both counts
    (unbiased running variance, ``momentum = 1 - decay``)."""
    if train:
        mean = torch.mean(h32, dim=0)
        var = torch.mean(h32 * h32, dim=0) - mean * mean
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
    bn = nn.ModuleList(RunningStats(d, device=device) for d in layer_sizes
                       ) if use_bn else nn.ModuleList()
    return tower, bn


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
    w = tower.out.w[:, 0].to(compute_dtype).float()
    out = torch.sum(h.float() * w, dim=1).to(compute_dtype)
    return (out + tower.out.b[0].to(compute_dtype)).float()


def l2_half_sum(x: torch.Tensor) -> torch.Tensor:
    """tf.nn.l2_loss semantics: 0.5 * sum(x^2)."""
    x = x.float()
    return 0.5 * torch.sum(x * x)


# ---------------------------------------------------------------------------
# Embedding schema: monolithic vs hash-bucketed multi-table layout
# ---------------------------------------------------------------------------

Entry = Union[torch.Tensor, Dict[str, torch.Tensor]]
Plan = Dict[str, emb_ops.PlanEntry]


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

    An *entry* is one param's table (monolithic) or dict of tables
    (hashed). In the model's flat state the hashed tables are named
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
        self.assign = cfg.embedding_assign
        self.kernels = cfg.embedding_kernels
        self.padded_vocab = emb_ops.padded_vocab(cfg.feature_size,
                                                 cfg.mesh_model)

    # -- layout ---------------------------------------------------------
    def table_keys(self) -> List[str]:
        if not self.hashed:
            return [self.MONO]
        return [f"t{i}" for i in range(len(self.buckets))]

    def table_rows(self, key: str) -> int:
        """Row count of one physical table."""
        if not self.hashed:
            return self.padded_vocab
        return self.buckets[int(key[1:])]

    def num_physical_rows(self) -> int:
        """Rows actually allocated (vs the logical feature_size)."""
        return sum(self.buckets) if self.hashed else self.padded_vocab

    def param_key(self, name: str, key: str) -> str:
        """Flat state name of one table of param ``name``."""
        return name if not self.hashed else f"{name}.{key}"

    def entry(self, params: Mapping[str, torch.Tensor], name: str) -> Entry:
        """Param ``name``'s entry out of a flat ``{name: tensor}`` state."""
        if not self.hashed:
            return params[name]
        return {k: params[self.param_key(name, k)] for k in self.table_keys()}

    def init_entry(self, trailing: Tuple[int, ...], *,
                   generator: Optional[torch.Generator],
                   device: torch.device) -> Entry:
        """Glorot-normal tables. Monolithic: over the REAL vocab, zero pad
        rows after it. Hashed: one glorot table per bucket count, drawn in
        table order from ``generator``."""
        if self.hashed:
            return {f"t{i}": glorot_normal((b, *trailing),
                                           generator=generator, device=device)
                    for i, b in enumerate(self.buckets)}
        t = glorot_normal((self.feature_size, *trailing),
                          generator=generator, device=device)
        pad = self.padded_vocab - self.feature_size
        if pad:
            t = torch.cat([t, torch.zeros((pad, *trailing), dtype=t.dtype,
                                          device=device)])
        return t

    def tables(self, entry: Entry) -> Dict[str, torch.Tensor]:
        """Uniform dict view of an entry: {key: [rows, ...] table}."""
        return entry if self.hashed else {self.MONO: entry}

    def from_tables(self, tables: Dict[str, torch.Tensor]) -> Entry:
        return tables if self.hashed else tables[self.MONO]

    # -- id -> (table, bucket) mapping ---------------------------------
    def _table_of(self, feat_ids: torch.Tensor) -> torch.Tensor:
        n = len(self.buckets)
        if self.assign == "field":
            f = torch.arange(feat_ids.shape[-1], dtype=torch.int32,
                             device=feat_ids.device) % n
            return f.expand(feat_ids.shape)
        return emb_ops.hash_table_assign(feat_ids, n)

    # -- dense forward --------------------------------------------------
    def lookup(self, entry: Entry, feat_ids: torch.Tensor) -> torch.Tensor:
        """[B,F,*trailing] gather (the dense path, eval and serving). The
        hashed parts are summed in table order t0, t1, ..., as the JAX
        package sums them."""
        if not self.hashed:
            return emb_ops.lookup(entry, feat_ids)
        table_of = self._table_of(feat_ids)
        out = None
        for i, b in enumerate(self.buckets):
            bucket = emb_ops.hash_bucket(feat_ids, b, salt=i + 1)
            tab = entry[f"t{i}"]
            part = tab.index_select(0, bucket.reshape(-1).long()).reshape(
                tuple(bucket.shape) + tuple(tab.shape[1:]))
            sel = emb_ops.trailing_dims((table_of == i).to(part.dtype),
                                        part.dim())
            part = part * sel
            out = part if out is None else out + part
        return out

    # -- sparse-update plan ---------------------------------------------
    def sparse_plan(self, feat_ids: torch.Tensor,
                    num_rows: Optional[int] = None) -> Plan:
        """One batch's dedup plan per table, through the
        ``embedding_kernels`` plan leg. ``num_rows`` overrides the
        monolithic fill id. The hashed tables' ids are built stacked,
        ``[T, B, F]``; on the kernel leg one plan launch serves up to
        ``ek.MAX_TABLES`` of them. On the card, when the take leg is the
        kernel, each entry also carries its position segments (built once
        here, shared by every embedding name's backward)."""
        if not self.hashed:
            rows = self.padded_vocab if num_rows is None else int(num_rows)
            plan = {self.MONO: ek.plan_build(feat_ids, rows,
                                             mode=self.kernels)}
        else:
            table_of = self._table_of(feat_ids)
            ids = torch.empty((len(self.buckets),) + tuple(feat_ids.shape),
                              dtype=torch.int32, device=feat_ids.device)
            masks = []
            for i, b in enumerate(self.buckets):
                bucket = emb_ops.hash_bucket(feat_ids, b, salt=i + 1)
                sel = table_of == i
                torch.where(sel, bucket, torch.full(
                    (), b, dtype=torch.int32, device=bucket.device),
                    out=ids[i])
                masks.append(sel.float())
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
            plan = dict(zip(keys, entries))
        if feat_ids.device.type == "cuda" and ek.resolve(
                self.kernels, "take") == "kernel":
            plan = {k: e._replace(segments=ek.position_segments(
                e.inv, e.uids.shape[0],
                keep=None if e.mask is None else e.mask > 0))
                for k, e in plan.items()}
        return plan

    def gather_rows(self, entry: Entry, plan: Plan) -> Dict[str, torch.Tensor]:
        """Touched rows per table: the sparse path's gradient leaf."""
        tabs = self.tables(entry)
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
    def l2(self, entry: Entry) -> torch.Tensor:
        """0.5*sum(x^2) over REAL rows: monolithic pad rows are masked out,
        so their gradient is exactly zero by construction; hashed tables
        have no pad rows and are summed table by table."""
        if self.hashed:
            return sum(l2_half_sum(t) for t in entry.values())
        return l2_half_sum(emb_ops.mask_pad_rows(entry, self.feature_size))

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

    def mask_pad_grads(self, grad_entry: torch.Tensor) -> torch.Tensor:
        """Zero pad-row gradients on the dense path (hashed tables have no
        pad rows: the identity)."""
        if self.hashed:
            return grad_entry
        return emb_ops.mask_pad_rows(grad_entry, self.feature_size)
