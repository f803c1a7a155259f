"""DLRM-DCNv2: MLPerf Training's recommendation model since v3.0
(MLCommons training ``recommendation_v2/torchrec_dlrm``; torchrec's
``DLRM_DCN``), on the port's input contract.

A row of ``feat_ids``/``feat_vals`` [B, F] holds ``DENSE_FEATURES`` (13)
dense columns, whose values the model reads (their ids reach no table),
then each sparse feature's bag of ``hotness[f]`` ids (values 1), in
feature order: F = 13 + sum(hotness). Feature f's ids are rows of its own
table (``EmbeddingSchema``'s per-feature layout, leaves ``embedding.t<f>``).

    bottom = relu(...relu(dense @ W1 + b1)...)              [B, K]
    bag_f  = sum_j emb_f[ids_f[:, j]]                        [B, K]
    x0     = [bottom, bag_0, ..., bag_{T-1}]                 [B, (T+1) K]
    x_{l+1} = x0 * (U_l (V_l x_l) + b_l) + x_l               (cross_layers)
    logit  = out(relu(...relu(x_L @ T1 + c1)...))            [B]

The products run in ``compute_dtype`` over float32 parameters, rounded as
the other graphs round them (``common.apply_hidden_stack``,
``graph.cross_network``, ``common.dense_head``); the bags are summed in
float32. There is no first-order term and no bias beside the top MLP's,
and ``l2_reg`` applies to no table (the source has none).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import DENSE_FEATURES, Config
from ..obs import trace as trace_lib
from ..ops.embedding import ModelAxis
from . import common
from .graph import GraphModel, cross_network, init_cross_layer


class DLRMDCNv2(GraphModel):
    """Bottom MLP, per-feature summed bags, a low-rank DCN-v2 cross network
    over their concatenation and a top MLP (``tower``) with its [d, 1]
    head. Built in eval mode; weights as ``GraphDeepFM`` draws them."""

    name = "dlrm_dcnv2"
    EMB = "embedding"

    def __init__(self, cfg: Config, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        dev, generator = self._init_device(cfg, device, generator)
        k = cfg.embedding_size
        self.bottom = common.Stack(DENSE_FEATURES, cfg.bottom_layer_sizes,
                                   use_bn=False, head=False,
                                   generator=generator, device=dev)
        setattr(self, self.EMB, self._embedding_param(
            self.emb.init_entry((k,), generator=generator, device=dev)))
        d = (len(cfg.table_row_counts) + 1) * k
        self.cross = nn.ModuleList(
            init_cross_layer(d, cfg.cross_rank, generator=generator,
                             device=dev)
            for _ in range(cfg.cross_layers))
        self.tower, self.bn = common.init_tower(
            d, cfg.deep_layer_sizes, cfg.batch_norm, generator=generator,
            device=dev)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.eval()

    def embedding_param_names(self) -> Tuple[str, ...]:
        return (self.EMB,)

    def l2_loss(self, params=None, *, emb_rows=None, emb_plan=None,
                shard: Optional[ModelAxis] = None) -> torch.Tensor:
        """Zero without ``l2_reg`` (the source's setting); else the other
        graphs' l2 over the tables."""
        if not self.cfg.l2_reg:
            tabs = (emb_rows[self.EMB] if emb_rows is not None
                    else self.emb.entry(params if params is not None else
                                        dict(self.named_parameters()),
                                        self.EMB))
            return torch.zeros((), dtype=torch.float32,
                               device=next(iter(tabs.values())).device)
        return super().l2_loss(params, emb_rows=emb_rows, emb_plan=emb_plan,
                               shard=shard)

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None,
                shard: Optional[ModelAxis] = None) -> torch.Tensor:
        """Logits [B] float32. ``emb_rows``/``emb_plan`` (the sparse update)
        replace the table lookups by views over pre-gathered rows."""
        cfg = self.cfg
        self._check_generator(generator)
        cdt = self.compute_dtype
        dev = feat_ids.device
        with trace_lib.span("bottom.fwd", device=dev):
            bottom = common.apply_hidden_stack(
                self.bottom.layers, self.bottom.bn,
                feat_vals[:, :DENSE_FEATURES].float(), train=self.training,
                dropout_keep=(), use_bn=False, bn_decay=cfg.batch_norm_decay,
                generator=None, compute_dtype=cdt)
        with trace_lib.span("embed.fwd", device=dev):
            if emb_rows is not None:
                bags = self.emb.pool_rows(emb_rows[self.EMB], emb_plan)
            else:
                bags = self.emb.pool(self._entry(self.EMB), feat_ids)
        with trace_lib.span("cross.fwd", device=dev):
            x0 = torch.cat([bottom, bags.reshape(bags.shape[0], -1).to(cdt)],
                           dim=1)
            x = cross_network(self.cross, x0)
        with trace_lib.span("tower.fwd", device=dev):
            return common.apply_tower(
                self.tower, self.bn, x, train=self.training,
                dropout_keep=cfg.dropout_rates, use_bn=cfg.batch_norm,
                bn_decay=cfg.batch_norm_decay, generator=generator,
                compute_dtype=cdt)
