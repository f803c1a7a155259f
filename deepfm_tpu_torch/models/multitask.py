"""Multi-task ranking heads over the feature->tower graph (port of
``deepfm_tpu.models.multitask``).

One embedding stage (the ``fm_w``/``fm_v`` entries of every single-task
graph), a shared bottom chosen by ``--multitask`` and one named head per
``--tasks`` entry; ``forward`` returns logits ``[B, T]``:

  * ``shared_bottom`` -- one shared DNN hidden stack; per-task linear heads.
  * ``mmoe`` -- Multi-gate Mixture-of-Experts (Ma et al., KDD 2018):
    ``--mmoe_experts`` hidden stacks, a per-task softmax gate over the
    expert outputs, per-task heads on the mixtures.
  * ``esmm`` -- Entire-Space Multi-task Model (Ma et al., SIGIR 2018) for
    CTR+CVR: per-task towers; the CVR head trains through pCTCVR = pCTR *
    pCVR on the full exposure space (:meth:`MultiTaskModel.per_example_loss`).

Per-task losses combine under ``--task_weights``. Labels are columns of the
batch: task 0 reads ``label``, task 1 ``label2``.

State names are the JAX trees flattened with dots: ``fm_b`` [T], ``fm_w``,
``fm_v``; ``bottom.layers.<i>.*`` (state ``bottom.bn.<i>.*``),
``experts.<e>.layers.<i>.*`` (``experts.<e>.bn.<i>.*``), ``gates.<t>.w``,
``heads.<t>.{w,b}``, or ``towers.<t>.{layers.<i>.*,out.*}``
(``towers.<t>.bn.<i>.*``). Dropout masks come from the one ``generator``
in expert and task order (the JAX package folds its key per expert or
task; the bits differ anyway).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from . import common, graph


class _Head(nn.Module):
    """One task's linear head: ``w`` [H, 1], ``b`` [1]."""

    def __init__(self, hdim: int, *, generator, device):
        super().__init__()
        self.w = nn.Parameter(common.glorot_uniform(
            (hdim, 1), generator=generator, device=device))
        self.b = nn.Parameter(torch.zeros(1, device=device))


class _Gate(nn.Module):
    """One task's MMoE gate: ``w`` [D, experts]."""

    def __init__(self, d: int, experts: int, *, generator, device):
        super().__init__()
        self.w = nn.Parameter(common.glorot_uniform(
            (d, experts), generator=generator, device=device))


class MultiTaskModel(graph.GraphModel):
    """Named task heads over a shared embedding and interaction bottom.
    Built in eval mode; weights as in ``graph.GraphDeepFM``."""

    def __init__(self, cfg: Config, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.task_names = tuple(cfg.task_names)
        self.arch = cfg.multitask
        self.name = f"multitask_{self.arch}"
        dev, generator = self._init_device(cfg, device, generator)
        t_count = self.num_tasks
        self.fm_b = nn.Parameter(torch.zeros(t_count, device=dev))
        self._init_embeddings(generator, dev)
        d = cfg.field_size * cfg.embedding_size
        hdim = cfg.deep_layer_sizes[-1] if cfg.deep_layer_sizes else d
        stack = dict(use_bn=cfg.batch_norm, generator=generator, device=dev)
        if self.arch == "esmm":
            self.towers = nn.ModuleList(
                common.Stack(d, cfg.deep_layer_sizes, head=True, **stack)
                for _ in range(t_count))
        elif self.arch == "mmoe":
            self.experts = nn.ModuleList(
                common.Stack(d, cfg.deep_layer_sizes, head=False, **stack)
                for _ in range(cfg.mmoe_experts))
            self.gates = nn.ModuleList(
                _Gate(d, cfg.mmoe_experts, generator=generator, device=dev)
                for _ in range(t_count))
        else:  # shared_bottom
            self.bottom = common.Stack(d, cfg.deep_layer_sizes, head=False,
                                       **stack)
        if self.arch != "esmm":
            self.heads = nn.ModuleList(
                _Head(hdim, generator=generator, device=dev)
                for _ in range(t_count))
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.eval()

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                emb_rows: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                emb_plan: Optional[common.Plan] = None) -> torch.Tensor:
        """Per-task logits [B, T] float32 (the contract of
        ``graph.GraphDeepFM.forward`` otherwise)."""
        cfg = self.cfg
        self._check_generator(generator)
        cdt = self.compute_dtype
        feat_vals = feat_vals.float()
        e = self._embed(feat_ids, feat_vals, emb_rows, emb_plan)
        xv = e["fm_v"] * feat_vals[..., None]
        y_first = graph.first_order(e["fm_w"], feat_vals)  # shared [B]
        deep_in = xv.reshape(xv.shape[0],
                             cfg.field_size * cfg.embedding_size)
        kw = dict(train=self.training, dropout_keep=cfg.dropout_rates,
                  use_bn=cfg.batch_norm, bn_decay=cfg.batch_norm_decay,
                  generator=generator, compute_dtype=cdt)
        outs = []
        if self.arch == "esmm":
            for t, tower in enumerate(self.towers):
                y = common.apply_tower(tower, tower.bn, deep_in, **kw)
                outs.append(self.fm_b[t] + y_first + y)
            return torch.stack(outs, dim=1)
        if self.arch == "mmoe":
            eo = torch.stack([common.apply_hidden_stack(
                ex.layers, ex.bn, deep_in, **kw) for ex in self.experts],
                dim=1)  # [B, N, H]
            x0c = deep_in.to(cdt)
            for t, gate_p in enumerate(self.gates):
                logit = common.narrow_matmul(x0c, gate_p.w)
                # jax.nn.softmax, op by op in the compute dtype.
                un = torch.exp(logit - torch.amax(logit, dim=-1,
                                                  keepdim=True))
                gate = un / torch.sum(un, dim=-1, keepdim=True)
                mix = torch.sum(eo * gate[..., None].to(eo.dtype), dim=1)
                head = self.heads[t]
                outs.append(self.fm_b[t] + y_first
                            + common.dense_head(mix, head.w, head.b))
            return torch.stack(outs, dim=1)
        h = common.apply_hidden_stack(self.bottom.layers, self.bottom.bn,
                                      deep_in, **kw)
        for t, head in enumerate(self.heads):
            outs.append(self.fm_b[t] + y_first
                        + common.dense_head(h, head.w, head.b))
        return torch.stack(outs, dim=1)

    # -- task combination ----------------------------------------------
    def per_example_loss(self, logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
        """Weighted per-example combined loss: [B,T] logits and labels ->
        [B]. ESMM replaces the independent per-task losses by its
        entire-space pair, BCE(pCTR, y_ctr) + BCE(pCTR * pCVR, y_ctr *
        y_cvr), pCTCVR clipped to [1e-7, 1 - 1e-7] in float32; the task
        weights still apply per term."""
        cfg = self.cfg
        wts = torch.tensor(cfg.task_weight_values, dtype=torch.float32,
                           device=logits.device)
        labels = labels.float()
        if self.arch == "esmm":
            y_ctr, y_cvr = labels[:, 0], labels[:, 1]
            l_ctr = _sigmoid_bce(logits[:, 0], y_ctr)
            eps = torch.tensor(1e-7, dtype=torch.float32,
                               device=logits.device)
            p_ctcvr = torch.clamp(
                torch.sigmoid(logits[:, 0]) * torch.sigmoid(logits[:, 1]),
                eps, 1.0 - eps)
            y_ctcvr = y_ctr * y_cvr
            l_ctcvr = -(y_ctcvr * torch.log(p_ctcvr)
                        + (1.0 - y_ctcvr) * torch.log1p(-p_ctcvr))
            return wts[0] * l_ctr + wts[1] * l_ctcvr
        if cfg.loss_type == "log_loss":
            per_task = _sigmoid_bce(logits, labels)
        else:  # square_loss
            per_task = torch.square(torch.sigmoid(logits) - labels)
        return per_task @ wts

    def probs_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Named per-task probabilities [B,T] (column t = task_names[t]).
        For ESMM the CVR column is the conditional CVR."""
        return torch.sigmoid(logits)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)
