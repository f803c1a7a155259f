"""Explicit feature->tower graph (port of ``deepfm_tpu.models.graph``).

A ranking model factors into embedding lookup (``fm_w`` [V], ``fm_v``
[V,K]), interaction blocks over the embedded features (first order, FM
second order, the DCN-v2 cross network, the DLRM dot interaction, the DNN
tower) and a head that sums them into one logit. ``GraphDeepFM``,
``GraphWideDeep``, ``GraphDCNv2`` and ``DLRM`` are the single-task graphs;
the multi-task heads (``models.multitask``) and the sequence models
(``models.sequence``) build on :class:`GraphModel` and
:class:`GraphDeepFM`.

Parameter names match the JAX param tree, flattened with dots: ``fm_b``,
``fm_w``, ``fm_v`` (``fm_w.t0``, ``fm_v.t0``, ... in the hash-bucketed
layout, a ``ParameterDict`` each), ``tower.layers.<i>.{w,b[,bn_scale,bn_bias]}``,
``tower.out.{w,b}``, DCN-v2's ``cross.<i>.{w|u,v,b}`` and ``head.{w,b}``;
the BN running statistics (the JAX model state ``{"bn": [...]}``) are
buffers ``bn.<i>.{mean,var}``. An artifact or a JAX param tree therefore
loads with ``load_state_dict``.

``forward`` is the JAX ``apply``: eval mode (``model.eval()``) is
``train=False``; training mode (``model.train()``) is ``train=True`` with
batch statistics, whose running update lands in the ``bn`` buffers in
place (the JAX package returns it as the new model state), and dropout
drawn from the ``generator`` argument (the JAX ``rng``).

The DLRM Gram product and the DCN-v2 cross products are plain large
products (``torch.matmul``), as the JAX package computes them outside any
Pallas kernel. DCN-v2 never reads ``fm_w``; it stays a parameter, an l2
term and an embedding name, so every update path gives it a zero
gradient, as JAX's does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..ops import fm as fm_ops
from ..ops.fused_fm import fused_fm
from ..utils import device as device_lib
from . import common


def first_order(w: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
    """Linear term sum_f W[ids]*vals. [B,F] -> [B]."""
    return torch.sum(w * feat_vals, dim=1)


def fm_block(cfg: Config, w: torch.Tensor, feat_vals: torch.Tensor,
             xv: torch.Tensor) -> torch.Tensor:
    """First-order + FM second-order: ``sum_f(W*vals) + FM(xv)``.

    ``cfg.use_pallas`` (the JAX package's switch, name kept) selects the
    fused op: on CUDA tensors the hand-written forward and backward kernels
    of ``csrc/fused_fm.cu``, for any F and K. Off, the plain formula. (The
    JAX package takes its Pallas kernel on a TPU only, so on the CPU its
    reference is the plain formula.)"""
    if cfg.use_pallas:
        return fused_fm(w, feat_vals, xv)
    return first_order(w, feat_vals) + fm_ops.fm_interaction(xv)


def init_cross_layer(d: int, cross_rank: int, *,
                     generator: Optional[torch.Generator],
                     device: torch.device) -> "CrossLayer":
    """One DCN-v2 cross layer: full-rank W [D,D] or low-rank U/V factors."""
    return CrossLayer(d, cross_rank, generator=generator, device=device)


class CrossLayer(nn.Module):
    """``w`` [D,D] (full rank) or ``u`` [r,D] and ``v`` [D,r]; ``b`` [D]."""

    def __init__(self, d: int, cross_rank: int, *,
                 generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        if cross_rank > 0:
            self.u = nn.Parameter(common.glorot_uniform(
                (cross_rank, d), generator=generator, device=device))
            self.v = nn.Parameter(common.glorot_uniform(
                (d, cross_rank), generator=generator, device=device))
        else:
            self.w = nn.Parameter(common.glorot_uniform(
                (d, d), generator=generator, device=device))
        self.b = nn.Parameter(torch.zeros(d, device=device))


def cross_network(cross: nn.ModuleList, x0c: torch.Tensor) -> torch.Tensor:
    """DCN-v2 cross tower: x_{l+1} = x0 * (W_l x_l + b_l) + x_l.

    ``x0c`` is already in the compute dtype; each layer's weights are cast
    to it inside the loop, as the JAX package casts them."""
    cdt = x0c.dtype
    x = x0c
    for layer in cross:
        if hasattr(layer, "u"):
            inner = (x @ layer.v.to(cdt)) @ layer.u.to(cdt)
        else:
            inner = x @ layer.w.to(cdt)
        x = x0c * (inner + layer.b.to(cdt)) + x
    return x


def dot_interaction(xv: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dot interaction: all F*(F-1)/2 distinct dots of the
    per-field vectors, [B,F,K] -> [B, F*(F-1)/2], from the Gram product
    and the static upper-triangle indices."""
    f = xv.shape[1]
    iu, ju = np.triu_indices(f, k=1)
    gram = torch.matmul(xv, xv.transpose(1, 2))  # [B,F,F]
    iu = torch.from_numpy(iu).to(xv.device)
    ju = torch.from_numpy(ju).to(xv.device)
    return gram[:, iu, ju]


class GraphModel(nn.Module):
    """Shared skeleton: owns the embedding schema and the embedding stage
    (dense lookups or the sparse update's row views, the l2 terms)."""

    name = "graph"
    task_names: Tuple[str, ...] = ("ctr",)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.emb = common.EmbeddingSchema(cfg)
        self.padded_vocab = self.emb.padded_vocab

    @property
    def num_tasks(self) -> int:
        return len(self.task_names)

    def embedding_param_names(self) -> Tuple[str, ...]:
        """The embedding params (the ones the l2 term covers)."""
        return ("fm_w", "fm_v")

    @staticmethod
    def _init_device(cfg: Config, device, generator):
        """(device, generator): the default generator is one on ``device``
        seeded with ``cfg.seed``; on the ``meta`` device none is drawn."""
        dev = device_lib.resolve(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        return dev, generator

    def _init_embeddings(self, generator, dev) -> None:
        self.fm_w = self._embedding_param(
            self.emb.init_entry((), generator=generator, device=dev))
        self.fm_v = self._embedding_param(
            self.emb.init_entry((self.cfg.embedding_size,),
                                generator=generator, device=dev))

    def _embedding_param(self, entry: common.Entry):
        """An entry as module state: one Parameter, or a ParameterDict of
        tables (state names ``<param>.t0``, ...) in the hashed layout."""
        if isinstance(entry, dict):
            return nn.ParameterDict({k: nn.Parameter(t)
                                     for k, t in entry.items()})
        return nn.Parameter(entry)

    def _entry(self, name: str) -> common.Entry:
        p = getattr(self, name)
        return dict(p.items()) if isinstance(p, nn.ParameterDict) else p

    def _check_generator(self, generator) -> None:
        """A training step never drops its dropout silently: a
        training-mode forward with a keep below 1 needs the generator."""
        cfg = self.cfg
        if self.training and generator is None and any(
                k < 1.0 for k in cfg.dropout_rates[:len(cfg.deep_layer_sizes)]):
            raise ValueError(
                "a training-mode forward with dropout keep < 1 needs a "
                "torch.Generator for the dropout masks")

    def _emb_lookup(self, name: str, feat_ids: torch.Tensor,
                    emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]],
                    emb_plan: Optional[common.Plan],
                    index: Optional[common.DenseIndex] = None
                    ) -> torch.Tensor:
        """Dense gather from the full tables at ``index`` (the batch's ids,
        shared by every name), or (sparse update) the view over the batch's
        pre-gathered rows ``emb_rows[name]``, which are then the gradient
        leaves."""
        if emb_rows is not None:
            return self.emb.lookup_rows(emb_rows[name], emb_plan)
        return self.emb.lookup(self._entry(name), feat_ids, index)

    def _embed(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor,
               emb_rows, emb_plan, names: Tuple[str, ...] = ("fm_w", "fm_v")
               ) -> Dict[str, torch.Tensor]:
        """The embedding stage: ``{name: [B,F,...]}`` for ``names``, the
        dense lookups sharing one index of the batch's ids."""
        index = None if emb_rows is not None else self.emb.dense_index(
            feat_ids, self._entry(names[0]))
        return {n: self._emb_lookup(n, feat_ids, emb_rows, emb_plan, index)
                for n in names}

    def l2_loss(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                *, emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        """l2_reg * pad-aware L2 over every embedding table, in full (the
        dense path), or over the batch's touched rows only when
        ``emb_rows``/``emb_plan`` are given (the sparse path). ``params``
        (flat state names) defaults to the module's own."""
        names = self.embedding_param_names()
        if emb_rows is not None:
            terms = [self.emb.l2_rows(emb_rows[n], emb_plan) for n in names]
        else:
            if params is None:
                params = dict(self.named_parameters())
            terms = [self.emb.l2(self.emb.entry(params, n)) for n in names]
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return self.cfg.l2_reg * total


class GraphDeepFM(GraphModel):
    """DeepFM as a graph: (fm_w, fm_v) -> [fm_block, tower] -> ctr head.

    Weights are drawn from ``generator`` (default: a generator on
    ``device`` seeded with ``cfg.seed``). On the ``meta`` device nothing is
    drawn: load weights with ``load_state_dict(..., assign=True)``. The
    module is built in eval mode."""

    name = "deepfm"

    def __init__(self, cfg: Config, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        dev, generator = self._init_device(cfg, device, generator)
        self.fm_b = nn.Parameter(torch.zeros(1, device=dev))
        self._init_embeddings(generator, dev)
        self.tower, self.bn = common.init_tower(
            self._tower_in_dim(), cfg.deep_layer_sizes, cfg.batch_norm,
            generator=generator, device=dev)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self._init_extra(generator, dev)
        self.eval()

    def _tower_in_dim(self) -> int:
        return self.cfg.field_size * self.cfg.embedding_size

    def _init_extra(self, generator, dev) -> None:
        """Parameters a subclass adds beside the DeepFM ones."""

    def _tower(self, x: torch.Tensor, generator) -> torch.Tensor:
        cfg = self.cfg
        return common.apply_tower(
            self.tower, self.bn, x, train=self.training,
            dropout_keep=cfg.dropout_rates, use_bn=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay, generator=generator,
            compute_dtype=self.compute_dtype)

    def _deep_in(self, xv: torch.Tensor) -> torch.Tensor:
        return xv.reshape(xv.shape[0],
                          self.cfg.field_size * self.cfg.embedding_size)

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        """Logits [B] float32 from int ids [B,F] and values [B,F].

        In training mode with a dropout keep below 1, ``generator`` (on the
        inputs' device) draws the dropout masks; it is required there, so a
        training step never drops its dropout silently. ``emb_rows`` and
        ``emb_plan`` (the sparse update) replace the table lookups by views
        over pre-gathered rows (``EmbeddingSchema.lookup_rows``)."""
        self._check_generator(generator)
        feat_vals = feat_vals.float()
        e = self._embed(feat_ids, feat_vals, emb_rows, emb_plan)
        w, v = e["fm_w"], e["fm_v"]  # [B,F], [B,F,K]
        xv = v * feat_vals[..., None]
        y_wv = fm_block(self.cfg, w, feat_vals, xv)
        y_d = self._tower(self._deep_in(xv), generator)
        return self.fm_b[0] + y_wv + y_d


class GraphWideDeep(GraphDeepFM):
    """Wide&Deep as a graph: first_order block + tower, no FM term."""

    name = "widedeep"

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        self._check_generator(generator)
        feat_vals = feat_vals.float()
        e = self._embed(feat_ids, feat_vals, emb_rows, emb_plan)
        y_wide = first_order(e["fm_w"], feat_vals)
        xv = e["fm_v"] * feat_vals[..., None]
        y_d = self._tower(self._deep_in(xv), generator)
        return self.fm_b[0] + y_wide + y_d


class GraphDCNv2(GraphDeepFM):
    """DCN-v2 as a graph: cross_network + hidden stack -> combination head
    over ``[cross_out (D), deep_out (H)]``; ``tower.out`` is a parameter
    that the forward never reads, as in the JAX package."""

    name = "dcnv2"

    def _init_extra(self, generator, dev) -> None:
        cfg = self.cfg
        d = cfg.field_size * cfg.embedding_size
        self.cross = nn.ModuleList(
            init_cross_layer(d, cfg.cross_rank, generator=generator,
                             device=dev)
            for _ in range(cfg.cross_layers))
        deep_out = cfg.deep_layer_sizes[-1] if cfg.deep_layer_sizes else d
        self.head = common.Dense(d + deep_out, 1, use_bn=False,
                                 generator=generator, device=dev)

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        cfg = self.cfg
        self._check_generator(generator)
        cdt = self.compute_dtype
        feat_vals = feat_vals.float()
        v = self._embed(feat_ids, feat_vals, emb_rows, emb_plan,
                        names=("fm_v",))["fm_v"]
        x0 = self._deep_in(v * feat_vals[..., None])
        cross_out = cross_network(self.cross, x0.to(cdt))
        h = common.apply_hidden_stack(
            self.tower.layers, self.bn, x0, train=self.training,
            dropout_keep=cfg.dropout_rates, use_bn=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay, generator=generator,
            compute_dtype=cdt)
        combined = torch.cat([cross_out, h.to(cdt)], dim=1)
        return self.fm_b[0] + common.dense_head(combined, self.head.w,
                                                self.head.b)


class DLRM(GraphDeepFM):
    """DLRM-style model: first order + tower over [xv, pairwise dots]
    (Naumov et al., 2019). Same input contract and tables as DeepFM."""

    name = "dlrm"

    def top_input_dim(self) -> int:
        cfg = self.cfg
        return (cfg.field_size * cfg.embedding_size
                + cfg.field_size * (cfg.field_size - 1) // 2)

    def _tower_in_dim(self) -> int:
        return self.top_input_dim()

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        self._check_generator(generator)
        feat_vals = feat_vals.float()
        e = self._embed(feat_ids, feat_vals, emb_rows, emb_plan)
        xv = e["fm_v"] * feat_vals[..., None]
        y_first = first_order(e["fm_w"], feat_vals)
        top_in = torch.cat([self._deep_in(xv), dot_interaction(xv)], dim=1)
        return self.fm_b[0] + y_first + self._tower(top_in, generator)
