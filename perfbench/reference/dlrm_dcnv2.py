"""Plain float32 reference of the benchmark's DLRM-DCNv2 cell: forward,
loss, gradients and the published Adagrad, in plain ``torch`` operations.

Imports nothing of the program. Matrix products run in float32 with TF32
off (``models.no_tf32``). Leaves are named as the program's state names
them (``bottom.layers.<i>.{w,b}``, ``embedding.t<f>``,
``cross.<l>.{u,v,b}``, ``tower.layers.<i>.{w,b}``, ``tower.out.{w,b}``).

The tables given here hold only the rows that the checked batches touch
(the family re-makes each table from the seed and keeps those rows), and
the batches' ids are those rows' places in them: Adagrad is exact, so a
row no batch touches keeps its value and its zero accumulator, and the
gradient's and the change's norms over the kept rows are the whole
table's.

    bottom = relu(...relu(vals[:, :13] @ W1 + b1)...)        [B, K]
    bag_f  = sum_j E_f[ids_f[:, j]]                          [B, K]
    x0     = [bottom, bag_0, ..., bag_{T-1}]                 [B, (T+1) K]
    x_{l+1} = x0 * ((x_l @ v_l) @ u_l + b_l) + x_l
    logit  = relu(...relu(x_L @ T1 + c1)...) @ out.w + out.b

Loss: the mean sigmoid cross-entropy. Adagrad: acc = acc + g^2, p = p +
(-lr) * (g / (sqrt(acc) + eps)), the accumulator from 0.

``quant`` (the control) computes every part one precision below the
configuration's: the products, the cross network's and the MLPs' adds in
float8 where the program computes them in bfloat16 (``models.Fp8Round``),
and the float32 parts (the bags, the loss's logits) in bfloat16
(``models.Bf16Round``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference import models as base

DENSE = 13


def _count(params: Dict[str, torch.Tensor], prefix: str, key: str) -> int:
    n = 0
    while f"{prefix}.{n}.{key}" in params:
        n += 1
    return n


def _mlp(params: Dict[str, torch.Tensor], prefix: str, h: torch.Tensor,
         quant: bool) -> torch.Tensor:
    for i in range(_count(params, prefix, "w")):
        h = torch.relu(base.dense(h, params[f"{prefix}.{i}.w"],
                                  params[f"{prefix}.{i}.b"], quant))
    return h


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor,
           vals: torch.Tensor, hotness: Sequence[int],
           quant: bool = False) -> torch.Tensor:
    """[B] float32 logits; ``ids`` index the tables given in ``params``."""
    r8 = base.Fp8Round.apply if quant else base._same
    r16 = base.Bf16Round.apply if quant else base._same
    parts = [_mlp(params, "bottom.layers", vals[:, :DENSE].float(), quant)]
    start = DENSE
    for f, hot in enumerate(hotness):
        rows = r16(params[f"embedding.t{f}"])[ids[:, start:start + hot]]
        parts.append(r16(rows.sum(dim=1)))
        start += hot
    x0 = r8(torch.cat(parts, dim=1))
    x = x0
    for layer in range(_count(params, "cross", "b")):
        xv = r8(r8(x) @ r8(params[f"cross.{layer}.v"]))
        inner = r8(xv @ r8(params[f"cross.{layer}.u"]))
        x = r8(x0 * r8(inner + r8(params[f"cross.{layer}.b"])) + x)
    h = _mlp(params, "tower.layers", x, quant)
    return r16(base.dense(h, params["tower.out.w"], params["tower.out.b"],
                          quant)[:, 0])


def loss(params: Dict[str, torch.Tensor], batch: Dict,
         hotness: Sequence[int], quant: bool = False) -> torch.Tensor:
    z = logits(params, batch["ids"], batch["vals"], hotness, quant)
    return torch.mean(F.binary_cross_entropy_with_logits(
        z, batch["label"].reshape(-1), reduction="none"))


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                hotness: Sequence[int], *, lr: float, eps: float = 1e-8,
                quant: bool = False, rows: Optional[slice] = None) -> Dict:
    """Adagrad over ``batches`` from ``params`` (copied, float32). Returns
    the loss of each step, the first step's gradient and the change of
    every leaf after the last step. ``rows`` keeps only those rows of every
    batch (a fault: part of the batch left out, the mean over the rest)."""
    with base.no_tf32():
        p = {k: v.detach().clone().float().requires_grad_()
             for k, v in params.items()}
        start = {k: v.detach().clone() for k, v in p.items()}
        acc = {k: torch.zeros_like(v) for k, v in start.items()}
        losses: List[float] = []
        g1: Dict[str, torch.Tensor] = {}
        names = list(p)
        for i, batch in enumerate(batches):
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            value = loss(p, batch, hotness, quant)
            grads = dict(zip(names, torch.autograd.grad(
                value, [p[n] for n in names])))
            losses.append(float(value.detach()))
            if i == 0:
                g1 = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, g in grads.items():
                    acc[k].add_(g * g)
                    p[k].add_((g / (torch.sqrt(acc[k]) + eps)) * -lr)
        change = {k: (p[k].detach() - start[k]) for k in p}
    return {"losses": losses, "grad1": g1, "change": change}
