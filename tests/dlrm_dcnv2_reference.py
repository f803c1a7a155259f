"""Plain float32 reference of DLRM-DCNv2 for the CPU tests: forward, loss,
gradients and the published Adagrad over whole (dense) tables, in plain
``torch`` with TF32 off. Imports neither JAX nor anything of the port.

Parameters are named as the port's state names them:
``bottom.layers.<i>.{w,b}``, ``embedding.t<f>`` [R_f, K],
``cross.<l>.{u,v,b}`` (u [r, D], v [D, r]), ``tower.layers.<i>.{w,b}``
and ``tower.out.{w,b}``; weights are [d_in, d_out], applied as ``x @ w``.

    bottom = relu(...relu(vals[:, :13] @ W1 + b1)...)
    bag_f  = sum_j E_f[ids[:, s_f + j]],  j < hotness[f]
    x0     = [bottom, bag_0, ..., bag_{T-1}]
    x_{l+1} = x0 * ((x_l @ v_l) @ u_l + b_l) + x_l
    logit  = relu(...relu(x_L @ T1 + c1)...) @ out.w + out.b

Loss: the mean sigmoid cross-entropy. Adagrad (MLPerf's: FBGEMM's exact
Adagrad and ``torch.optim.Adagrad``): acc = acc + g^2, p = p - lr * g /
(sqrt(acc) + eps), the accumulator from 0.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

DENSE = 13


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _count(params: Dict[str, torch.Tensor], prefix: str, key: str) -> int:
    n = 0
    while f"{prefix}.{n}.{key}" in params:
        n += 1
    return n


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor,
           vals: torch.Tensor, hotness: Sequence[int]) -> torch.Tensor:
    """[B] float32 logits."""
    h = vals[:, :DENSE].float()
    for i in range(_count(params, "bottom.layers", "w")):
        h = torch.relu(h @ params[f"bottom.layers.{i}.w"]
                       + params[f"bottom.layers.{i}.b"])
    parts, start = [h], DENSE
    for f, hot in enumerate(hotness):
        rows = params[f"embedding.t{f}"][ids[:, start:start + hot].long()]
        parts.append(rows.sum(dim=1))
        start += hot
    x0 = torch.cat(parts, dim=1)
    x = x0
    for layer in range(_count(params, "cross", "b")):
        inner = (x @ params[f"cross.{layer}.v"]) @ params[f"cross.{layer}.u"]
        x = x0 * (inner + params[f"cross.{layer}.b"]) + x
    for i in range(_count(params, "tower.layers", "w")):
        x = torch.relu(x @ params[f"tower.layers.{i}.w"]
                       + params[f"tower.layers.{i}.b"])
    return x @ params["tower.out.w"][:, 0] + params["tower.out.b"][0]


def loss(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         hotness: Sequence[int]) -> torch.Tensor:
    z = logits(params, batch["feat_ids"], batch["feat_vals"], hotness)
    return F.binary_cross_entropy_with_logits(
        z, batch["label"].reshape(-1).float())


def loss_and_grads(params: Dict[str, torch.Tensor], batch: Dict,
                   hotness: Sequence[int]):
    """(loss, {leaf: gradient}) at ``params`` (not changed)."""
    with no_tf32():
        p = {k: v.detach().clone().float().requires_grad_()
             for k, v in params.items()}
        value = loss(p, batch, hotness)
        names = list(p)
        grads = torch.autograd.grad(value, [p[n] for n in names])
    return value.detach(), dict(zip(names, grads))


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                hotness: Sequence[int], *, lr: float,
                eps: float = 1e-8) -> Dict:
    """Adagrad over ``batches`` from ``params`` (copied): each step's loss,
    the first step's gradients and the final parameters."""
    p = {k: v.detach().clone().float() for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    grad1: Dict[str, torch.Tensor] = {}
    for i, batch in enumerate(batches):
        value, grads = loss_and_grads(p, batch, hotness)
        losses.append(float(value))
        if i == 0:
            grad1 = grads
        with torch.no_grad():
            for k, g in grads.items():
                acc[k].add_(g * g)
                p[k].add_((g / (torch.sqrt(acc[k]) + eps)) * -lr)
    return {"losses": losses, "grad1": grad1, "params": p}
