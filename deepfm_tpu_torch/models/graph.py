"""Explicit feature->tower graph (the DeepFM part of ``deepfm_tpu.models.graph``).

A ranking model factors into embedding lookup (``fm_w`` [V], ``fm_v``
[V,K]), interaction blocks over the embedded features (first order, FM
second order, the DNN tower) and a head that sums them into one logit.

Parameter names match the JAX param tree, flattened with dots: ``fm_b``,
``fm_w``, ``fm_v`` (``fm_w.t0``, ``fm_v.t0``, ... in the hash-bucketed
layout, a ``ParameterDict`` each), ``tower.layers.<i>.{w,b[,bn_scale,bn_bias]}``,
``tower.out.{w,b}``; the BN running statistics (the JAX model state
``{"bn": [...]}``) are buffers ``bn.<i>.{mean,var}``. An artifact or a JAX
param tree therefore loads with ``load_state_dict``.

``forward`` is the JAX ``apply``: eval mode (``model.eval()``) is
``train=False``; training mode (``model.train()``) is ``train=True`` with
batch statistics, whose running update lands in the ``bn`` buffers in
place (the JAX package returns it as the new model state), and dropout
drawn from the ``generator`` argument (the JAX ``rng``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


class GraphModel(nn.Module):
    """Shared skeleton: owns the embedding schema."""

    name = "graph"

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.emb = common.EmbeddingSchema(cfg)
        self.padded_vocab = self.emb.padded_vocab

    def embedding_param_names(self) -> Tuple[str, ...]:
        """The embedding params (the ones the l2 term covers)."""
        return ("fm_w", "fm_v")

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
        dev = device_lib.resolve(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.fm_b = nn.Parameter(torch.zeros(1, device=dev))
        self.fm_w = self._embedding_param(
            self.emb.init_entry((), generator=generator, device=dev))
        self.fm_v = self._embedding_param(
            self.emb.init_entry((cfg.embedding_size,), generator=generator,
                                device=dev))
        self.tower, self.bn = common.init_tower(
            cfg.field_size * cfg.embedding_size, cfg.deep_layer_sizes,
            cfg.batch_norm, generator=generator, device=dev)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.eval()

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
        cfg = self.cfg
        if self.training and generator is None and any(
                k < 1.0 for k in cfg.dropout_rates[:len(cfg.deep_layer_sizes)]):
            raise ValueError(
                "a training-mode forward with dropout keep < 1 needs a "
                "torch.Generator for the dropout masks")
        feat_vals = feat_vals.float()
        index = None if emb_rows is not None else self.emb.dense_index(
            feat_ids, self._entry("fm_w"))
        w = self._emb_lookup("fm_w", feat_ids, emb_rows, emb_plan,
                             index)  # [B,F]
        v = self._emb_lookup("fm_v", feat_ids, emb_rows, emb_plan,
                             index)  # [B,F,K]
        xv = v * feat_vals[..., None]
        y_wv = fm_block(cfg, w, feat_vals, xv)
        deep_in = xv.reshape(xv.shape[0], cfg.field_size * cfg.embedding_size)
        y_d = common.apply_tower(
            self.tower, self.bn, deep_in, train=self.training,
            dropout_keep=cfg.dropout_rates, use_bn=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay, generator=generator,
            compute_dtype=self.compute_dtype)
        return self.fm_b[0] + y_wv + y_d
