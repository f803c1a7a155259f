"""Explicit feature->tower graph (the DeepFM part of ``deepfm_tpu.models.graph``).

A ranking model factors into embedding lookup (``fm_w`` [V], ``fm_v``
[V,K]), interaction blocks over the embedded features (first order, FM
second order, the DNN tower) and a head that sums them into one logit.

Parameter names match the JAX param tree, flattened with dots: ``fm_b``,
``fm_w``, ``fm_v``, ``tower.layers.<i>.{w,b[,bn_scale,bn_bias]}``,
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

from typing import Mapping, Optional, Tuple

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
        """The embedding tables (the params the l2 term covers)."""
        return ("fm_w", "fm_v")

    def l2_loss(self, params: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """l2_reg * pad-aware L2 over every embedding table, in full (the
        dense path's semantics). ``params`` defaults to the module's own."""
        if params is None:
            params = dict(self.named_parameters())
        names = self.embedding_param_names()
        total = self.emb.l2(params[names[0]])
        for n in names[1:]:
            total = total + self.emb.l2(params[n])
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
        self.fm_w = nn.Parameter(
            self.emb.init_entry((), generator=generator, device=dev))
        self.fm_v = nn.Parameter(
            self.emb.init_entry((cfg.embedding_size,), generator=generator,
                                device=dev))
        self.tower, self.bn = common.init_tower(
            cfg.field_size * cfg.embedding_size, cfg.deep_layer_sizes,
            cfg.batch_norm, generator=generator, device=dev)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.eval()

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B] float32 from int ids [B,F] and values [B,F].

        In training mode with a dropout keep below 1, ``generator`` (on the
        inputs' device) draws the dropout masks; it is required there, so a
        training step never drops its dropout silently."""
        cfg = self.cfg
        if self.training and generator is None and any(
                k < 1.0 for k in cfg.dropout_rates[:len(cfg.deep_layer_sizes)]):
            raise ValueError(
                "a training-mode forward with dropout keep < 1 needs a "
                "torch.Generator for the dropout masks")
        feat_vals = feat_vals.float()
        w = self.emb.lookup(self.fm_w, feat_ids)          # [B,F]
        v = self.emb.lookup(self.fm_v, feat_ids)          # [B,F,K]
        xv = v * feat_vals[..., None]
        y_wv = fm_block(cfg, w, feat_vals, xv)
        deep_in = xv.reshape(xv.shape[0], cfg.field_size * cfg.embedding_size)
        y_d = common.apply_tower(
            self.tower, self.bn, deep_in, train=self.training,
            dropout_keep=cfg.dropout_rates, use_bn=cfg.batch_norm,
            bn_decay=cfg.batch_norm_decay, generator=generator,
            compute_dtype=self.compute_dtype)
        return self.fm_b[0] + y_wv + y_d
