"""Sequence models over the user-history input: DIN and BST target
attention (port of ``deepfm_tpu.models.sequence``).

Batches may carry ``hist_ids`` int32 [B, L] and ``hist_mask`` float32
[B, L] (the pipeline's fixed-shape padding of the ragged on-disk
``hist_ids``/``hist_vals`` pair); the graphs attend over that history with
the candidate as the query:

  * ``GraphDIN`` -- Deep Interest Network (Zhou et al., KDD'18) target
    attention: additive-MLP relevance scores between the candidate and each
    history embedding, the mask-aware softmax (``ops.fm.masked_softmax``:
    exact zeros on empty histories), the attended history appended to the
    DeepFM tower input.
  * ``GraphBST`` -- Behavior Sequence Transformer (Chen et al., 2019): one
    single-head self-attention block with learned positions over
    ``[history..., target]`` in float32; the target slot's output is the
    history summary.

Both keep the whole DeepFM path (``fm_block``: the fused FM kernel on the
card). The history gathers ``fm_v`` through the dense schema lookup with
an index of its own (``EmbeddingSchema.dense_index`` of ``hist_ids``), so
the ``fm_v`` gradient is the sum of two position-ordered segment sums.
Called without history they see an empty one (one all-masked position),
whose attention contributes exact zeros. State names: DIN's
``att.{w1,b1,w2,b2}``, BST's ``att.{pos,target_pos,wq,wk,wv}``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import fm as fm_ops
from . import common
from .graph import GraphDeepFM, fm_block


class TargetAttention(nn.Module):
    """DIN attention unit: an additive MLP over [query, key, query - key,
    query * key] -> score. ``w1`` [4K, att], ``b1``, ``w2`` [att, 1],
    ``b2`` [1]."""

    def __init__(self, k_dim: int, att_dim: int, *, generator, device):
        super().__init__()
        self.w1 = nn.Parameter(common.glorot_uniform(
            (4 * k_dim, att_dim), generator=generator, device=device))
        self.b1 = nn.Parameter(torch.zeros(att_dim, device=device))
        self.w2 = nn.Parameter(common.glorot_uniform(
            (att_dim, 1), generator=generator, device=device))
        self.b2 = nn.Parameter(torch.zeros(1, device=device))


def init_target_attention(k_dim: int, att_dim: int, *, generator,
                          device) -> TargetAttention:
    return TargetAttention(k_dim, att_dim, generator=generator, device=device)


def target_attention(att: TargetAttention, query: torch.Tensor,
                     keys: torch.Tensor, mask: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """query [B, K], keys [B, L, K], mask [B, L] (> 0: a real position) ->
    the attention-weighted history sum [B, K] float32; an all-masked row
    gives exact zeros. The score layer is a row-wise dot
    (``common.dense_head``)."""
    cdt = compute_dtype
    q = query[:, None, :].expand(keys.shape).to(cdt)
    k = keys.to(cdt)
    feats = torch.cat([q, k, q - k, q * k], dim=-1)  # [B, L, 4K]
    h = torch.relu(feats @ att.w1.to(cdt) + att.b1.to(cdt))
    scores = common.dense_head(h, att.w2, att.b2)  # [B, L]
    weights = fm_ops.masked_softmax(scores, mask.float())
    return torch.sum(weights[..., None] * keys.float(), dim=1)


def _empty_history(batch: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stand-in when a caller passes no history: one all-masked
    position, so the attention output is exactly zero."""
    return (torch.zeros((batch, 1), dtype=torch.int32, device=device),
            torch.zeros((batch, 1), dtype=torch.float32, device=device))


class GraphDIN(GraphDeepFM):
    """DeepFM + DIN target attention over the user history; the tower input
    grows by one K-vector (the attended history)."""

    name = "din"
    #: the trainer forwards hist_ids/hist_mask batch columns when present
    uses_history = True

    def _att_dim(self) -> int:
        return max(8, 2 * self.cfg.embedding_size)

    def _tower_in_dim(self) -> int:
        cfg = self.cfg
        return cfg.field_size * cfg.embedding_size + cfg.embedding_size

    def _init_extra(self, generator, dev) -> None:
        self.att = init_target_attention(
            self.cfg.embedding_size, self._att_dim(), generator=generator,
            device=dev)

    def _history_keys(self, hist_ids: torch.Tensor) -> torch.Tensor:
        """[B, L, K]: the dense schema lookup of ``fm_v`` at the history's
        own index (the sparse plan covers feat_ids only; the config refuses
        history with the sparse update)."""
        return self.emb.lookup(self._entry("fm_v"), hist_ids)

    def _history_summary(self, query: torch.Tensor, hist_ids: torch.Tensor,
                         hist_mask: torch.Tensor) -> torch.Tensor:
        return target_attention(self.att, query, self._history_keys(hist_ids),
                                hist_mask, compute_dtype=self.compute_dtype)

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None,
                hist_ids: Optional[torch.Tensor] = None,
                hist_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B]; ``hist_ids`` int [B, L] and ``hist_mask`` [B, L]
        (both or neither)."""
        self._check_generator(generator)
        feat_vals = feat_vals.float()
        if hist_ids is None:
            hist_ids, hist_mask = _empty_history(feat_ids.shape[0],
                                                 feat_ids.device)
        e = self._embed(feat_ids, feat_vals, emb_rows, emb_plan)
        w, v = e["fm_w"], e["fm_v"]
        xv = v * feat_vals[..., None]
        # Candidate query: the value-weighted sum of the example's field
        # embeddings.
        query = torch.sum(xv, dim=1)  # [B, K]
        hist = self._history_summary(query, hist_ids, hist_mask)  # [B, K]
        y_wv = fm_block(self.cfg, w, feat_vals, xv)
        deep_in = torch.cat([self._deep_in(xv), hist], dim=1)
        return self.fm_b[0] + y_wv + self._tower(deep_in, generator)


class BSTAttention(nn.Module):
    """BST's block: ``pos`` [max(1, L), K] and ``target_pos`` [K] learned
    positions, ``wq``/``wk``/``wv`` [K, K]."""

    def __init__(self, rows: int, k_dim: int, *, generator, device):
        super().__init__()

        def normal(shape):
            return 0.01 * common._draw(
                lambda t, g: t.normal_(0.0, 1.0, generator=g), shape,
                generator, device)

        self.pos = nn.Parameter(normal((rows, k_dim)))
        self.target_pos = nn.Parameter(normal((k_dim,)))
        for name in ("wq", "wk", "wv"):
            setattr(self, name, nn.Parameter(common.glorot_uniform(
                (k_dim, k_dim), generator=generator, device=device)))


class GraphBST(GraphDIN):
    """DeepFM + one transformer block over [history..., target]. The
    position table has ``max(1, history_max_len)`` rows; a longer history
    raises (train and serve with the same ``--history_max_len``)."""

    name = "bst"

    def _pos_rows(self) -> int:
        return max(1, int(getattr(self.cfg, "history_max_len", 0) or 0))

    def _init_extra(self, generator, dev) -> None:
        self.att = BSTAttention(self._pos_rows(), self.cfg.embedding_size,
                                generator=generator, device=dev)

    def _history_summary(self, query: torch.Tensor, hist_ids: torch.Tensor,
                         hist_mask: torch.Tensor) -> torch.Tensor:
        att = self.att
        ln = hist_ids.shape[1]
        if ln > att.pos.shape[0]:
            raise ValueError(
                f"history length {ln} exceeds the learned position table "
                f"({att.pos.shape[0]} rows) — train and serve with the "
                "same --history_max_len")
        keys = self._history_keys(hist_ids)  # [B, L, K]
        seq = torch.cat([keys + att.pos[None, :ln, :],
                         (query + att.target_pos)[:, None, :]], dim=1)
        mask = torch.cat([(hist_mask > 0).float(),
                          torch.ones((hist_ids.shape[0], 1),
                                     dtype=torch.float32,
                                     device=hist_ids.device)], dim=1)
        q = seq @ att.wq
        k = seq @ att.wk
        v = seq @ att.wv
        scores = torch.einsum("blk,bmk->blm", q, k) / torch.sqrt(
            torch.tensor(float(seq.shape[-1]), dtype=torch.float32,
                         device=seq.device))
        weights = fm_ops.masked_softmax(scores, mask[:, None, :])
        out = torch.einsum("blm,bmk->blk", weights, v) + seq  # residual
        return out[:, -1, :]  # the target slot's output
