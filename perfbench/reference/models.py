"""Plain float32 reference of the benchmark's training cells: DeepFM's
forward, loss, gradients and Adam, in plain ``torch`` operations.

Imports nothing of the program. Matrix products run in float32 with TF32
off (:func:`no_tf32`). Leaves are named as the program's state names them
(``fm_b``, ``fm_w``, ``fm_v``, ``tower.layers.<i>.{w,b}``,
``tower.out.{w,b}``); the tables hold the real vocabulary's rows only.

The model (DeepFM, Guo et al. 2017, as the reference recipe trains it):

    xv     = V[ids] * vals[..., None]                       [B, F, K]
    first  = sum_f W[ids] * vals                            [B]
    fm     = 0.5 * sum_k ((sum_f xv)^2 - sum_f xv^2)         [B]
    deep   = out(relu(...relu(flat(xv) @ W1 + b1)...))       [B]
    logit  = b + first + fm + deep

Loss: the mean sigmoid cross-entropy plus ``l2 * 0.5 * sum(x^2)`` over both
tables. Adam: optax's (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
corrections in float32).

``quant`` (the control) computes every part one precision below the
configuration's: the tower in float8 where the program computes it in
bfloat16 (:class:`Fp8Round`: each product's operands, each product and
each bias add, and the gradients flowing back) and the float32 parts in
bfloat16 (:class:`Bf16Round`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


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


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` under a per-tensor scale (its
    largest magnitude to the type's largest), back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Fp8Round(torch.autograd.Function):
    """A tensor as float8 training holds it: e4m3 in the forward pass,
    its gradient e5m2 in the backward pass, each under a per-tensor
    scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Bf16Round(torch.autograd.Function):
    """A float32 tensor held in bfloat16, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def tower_layers(params: Dict[str, torch.Tensor]) -> int:
    n = 0
    while f"tower.layers.{n}.w" in params:
        n += 1
    return n


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          quant: bool) -> torch.Tensor:
    if quant:
        r = Fp8Round.apply
        return r(r(r(h) @ r(w)) + r(b))
    return h @ w + b


def tower(params: Dict[str, torch.Tensor], x: torch.Tensor,
          quant: bool = False) -> torch.Tensor:
    h = x
    for i in range(tower_layers(params)):
        h = torch.relu(dense(h, params[f"tower.layers.{i}.w"],
                             params[f"tower.layers.{i}.b"], quant))
    return dense(h, params["tower.out.w"], params["tower.out.b"],
                 quant)[:, 0]


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor,
           vals: torch.Tensor, quant: bool = False) -> torch.Tensor:
    """[B] float32 logits. Under ``quant`` every part runs one precision
    below the configuration's: the tower in float8, the float32 parts
    (rows, FM, first order, the logit) in bfloat16."""
    r16 = Bf16Round.apply if quant else _same
    ids = ids.long()
    w = r16(params["fm_w"][ids])                 # [B, F]
    v = r16(params["fm_v"][ids])                 # [B, F, K]
    xv = r16(v * vals[..., None])
    first = r16(torch.sum(r16(w * vals), dim=1))
    flat = xv.reshape(xv.shape[0], -1)
    s = r16(torch.sum(xv, dim=1))
    fm = r16(0.5 * torch.sum(r16(s * s) - r16(torch.sum(xv * xv, dim=1)),
                             dim=1))
    return r16(params["fm_b"][0] + first + fm + tower(params, flat, quant))


def loss(params: Dict[str, torch.Tensor], batch: Dict, l2: float,
         quant: bool = False) -> torch.Tensor:
    z = logits(params, batch["ids"], batch["vals"], quant)
    y = batch["label"].reshape(-1)
    xent = torch.mean(F.binary_cross_entropy_with_logits(z, y,
                                                          reduction="none"))
    reg = 0.5 * (torch.sum(params["fm_w"] ** 2)
                 + torch.sum(params["fm_v"] ** 2))
    return xent + l2 * reg


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        t = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            params[k].add_(u * -self.lr)


def train_steps(params: Dict[str, torch.Tensor],
                batches: Sequence[Dict], *, lr: float, l2: float,
                quant: bool = False, rows: Optional[slice] = None) -> Dict:
    """Adam over ``batches`` from ``params`` (copied, float32). Returns the
    loss of each step, the first step's gradient and the change of every
    leaf after the last step. ``rows`` keeps only those rows of every
    batch (a fault: part of the batch left out, the mean over the rest)."""
    with no_tf32():
        p = {k: v.detach().clone().float().requires_grad_()
             for k, v in params.items()}
        start = {k: v.detach().clone() for k, v in p.items()}
        opt = Adam(lr)
        losses: List[float] = []
        g1: Dict[str, torch.Tensor] = {}
        for i, batch in enumerate(batches):
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            value = loss(p, batch, l2, quant)
            names = list(p)
            grads = dict(zip(names, torch.autograd.grad(
                value, [p[n] for n in names])))
            losses.append(float(value.detach()))
            if i == 0:
                g1 = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(p, grads)
        change = {k: (p[k].detach() - start[k]) for k in p}
    return {"losses": losses, "grad1": g1, "change": change}
