"""Optimizers with optax's arithmetic, and the sparse embedding update's
lazy Adam (port of ``deepfm_tpu.train.optimizers``).

The JAX package builds its optimizers with optax; ``torch.optim`` orders
and seeds the same algorithms differently (its Adam divides in another
order; its Adagrad starts the accumulator at 0 and adds eps outside the
square root), which a few steps already show. So each optimizer here
repeats optax's formulas, operation for operation:

  * Adam (b1 0.9, b2 0.999, eps 1e-8, optax's eps_root 0):
      mu = (1-b1)*g + b1*mu;  nu = (1-b2)*g^2 + b2*nu;  t += 1
      u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)
  * Adagrad (initial accumulator 1e-8, eps 1e-7):
      acc = g^2 + acc;  u = where(acc > 0, rsqrt(acc + eps), 0) * g
  * Momentum (optax.sgd with momentum 0.95, the trace):  t = g + 0.95*t;
    u = t.  SGD without momentum: u = g.
  * FTRL-Proximal, the JAX package's own transformation (``ftrl``).

and the step is ``p = p + (-lr) * u``. These update every row of every
table each step (the dense path); with ``--embedding_update sparse`` the
embedding tables take the lazy Adam at the end of this module instead.
Updates are written in place with ``torch._foreach_*`` over the parameter
list, under ``torch.no_grad()``.

State is a plain dict of tensors keyed by parameter name (plus the step
count ``count`` as a Python int for Adam, whose bias correction is computed
on the host in float32), so it checkpoints with ``torch.save``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import embedding as emb_ops

Params = Dict[str, torch.Tensor]


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v, memory_format=torch.contiguous_format)
            for k, v in params.items()}


def _lists(params: Params, grads: Params, *slots: Params):
    names = list(params)
    return ([params[n] for n in names], [grads[n] for n in names],
            *([s[n] for n in names] for s in slots))


def _apply_step(ps: List[torch.Tensor], us: List[torch.Tensor],
                lr: float) -> None:
    """p = p + (-lr) * u, the product rounded before the add as optax's
    scale_by_learning_rate + apply_updates round it."""
    torch._foreach_mul_(us, -lr)
    torch._foreach_add_(ps, us)


class Adam:
    def __init__(self, lr: float, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Params) -> dict:
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: dict) -> None:
        ps, gs, mus, nus = _lists(params, grads, state["mu"], state["nu"])
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - self.b1))
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self.b2))
        state["count"] += 1
        # optax: 1 - decay**count in float32, then t / that.
        t = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        mu_hat = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        _apply_step(ps, torch._foreach_div(mu_hat, den), self.lr)


class Adagrad:
    def __init__(self, lr: float, *, initial_accumulator_value: float = 1e-8,
                 eps: float = 1e-7):
        self.lr, self.init_acc, self.eps = lr, initial_accumulator_value, eps

    def init(self, params: Params) -> dict:
        return {"sum_of_squares": {
            k: torch.full_like(v, self.init_acc) for k, v in params.items()}}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: dict) -> None:
        ps, gs, accs = _lists(params, grads, state["sum_of_squares"])
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_add_(sq, accs)
        for acc, s in zip(accs, sq):
            acc.copy_(s)
        us = []
        for s, g in zip(sq, gs):
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros((), dtype=s.dtype, device=s.device))
            us.append(inv * g)
        _apply_step(ps, us, self.lr)


class Sgd:
    """optax.sgd: with ``momentum`` the trace ``t = g + momentum * t``."""

    def __init__(self, lr: float, *, momentum=None):
        self.lr, self.momentum = lr, momentum

    def init(self, params: Params) -> dict:
        return {"trace": _zeros(params)} if self.momentum is not None else {}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: dict) -> None:
        if self.momentum is None:
            ps, gs = _lists(params, grads)
            _apply_step(ps, [g.clone() for g in gs], self.lr)
            return
        ps, gs, traces = _lists(params, grads, state["trace"])
        new = torch._foreach_mul(traces, self.momentum)
        new = torch._foreach_add(gs, new)
        for t, n in zip(traces, new):
            t.copy_(n)
        _apply_step(ps, [n.clone() for n in new], self.lr)


class Ftrl:
    """FTRL-Proximal (McMahan et al. 2013), the JAX package's ``ftrl``:

        n_new = n + g^2;  sigma = (n_new^p - n^p) / lr;  z += g - sigma*w
        w = 0 if |z| <= l1 else
            -(z - sign(z)*l1) / ((beta + n_new^p)/lr + 2*l2),  p = -lr_power
    """

    def __init__(self, lr: float, *, learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0, beta: float = 0.0):
        if learning_rate_power > 0:
            raise ValueError("learning_rate_power must be <= 0")
        self.lr, self.p = lr, -learning_rate_power
        self.init_acc = initial_accumulator_value
        self.l1, self.l2, self.beta = (l1_regularization_strength,
                                       l2_regularization_strength, beta)

    def init(self, params: Params) -> dict:
        return {"z": _zeros(params),
                "n": {k: torch.full_like(v, self.init_acc)
                      for k, v in params.items()}}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: dict) -> None:
        for name, w in params.items():
            g = grads[name].float()
            z, n = state["z"][name], state["n"][name]
            n_new = n + g * g
            sigma = (torch.pow(n_new, self.p) - torch.pow(n, self.p)) / self.lr
            z_new = z + g - sigma * w
            denom = ((self.beta + torch.pow(n_new, self.p)) / self.lr
                     + 2.0 * self.l2)
            w_new = torch.where(
                torch.abs(z_new) <= self.l1, torch.zeros_like(w),
                -(z_new - torch.sign(z_new) * self.l1) / denom)
            # optax.apply_updates adds the delta (w_new - w) to w.
            w.add_(w_new - w)
            z.copy_(z_new)
            n.copy_(n_new)


# ---------------------------------------------------------------------------
# Sparse (touched-rows-only) Adam with lazy, timestamped moment correction
# ---------------------------------------------------------------------------
#
# The JAX package's lazy Adam (``deepfm_tpu.train.optimizers``): per row the
# moments (m, v) and the step count ``tau`` at which the row was last
# touched. On a touch at global step ``count`` (1-based):
#
#     m = b1^(count-tau) * m + (1 - b1) * g
#     v = b2^(count-tau) * v + (1 - b2) * g^2
#     row -= (lr * m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps)
#
# which is dense Adam's value for that row had its idle steps' zero
# gradients been applied one by one. The formulas below repeat the JAX
# package's operation order; the bias corrections are float32 values
# computed on the host, as the dense ``Adam`` computes them.


class EmbedAdamEntry(NamedTuple):
    """Per-table lazy-Adam slots: m, v float32 like the table, ``tau``
    int32 [rows], the step count at which each row was last touched."""
    m: torch.Tensor
    v: torch.Tensor
    tau: torch.Tensor


def embed_adam_init(table: torch.Tensor) -> EmbedAdamEntry:
    return EmbedAdamEntry(
        m=torch.zeros_like(table, dtype=torch.float32),
        v=torch.zeros_like(table, dtype=torch.float32),
        tau=torch.zeros(table.shape[0], dtype=torch.int32,
                        device=table.device))


def _bias_corrections(count: int, b1: float, b2: float):
    """``1 - b^count`` in float32 for both betas (Python floats)."""
    t = np.float32(count)
    return (float(np.float32(1) - np.float32(b1) ** t),
            float(np.float32(1) - np.float32(b2) ** t))


@torch.no_grad()
def sparse_adam_rows(rows0: torch.Tensor, g_rows: torch.Tensor,
                     m_rows: torch.Tensor, v_rows: torch.Tensor,
                     tau_rows: torch.Tensor, count: int, *, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One lazy-Adam step on gathered rows [U, ...]; returns (new_rows,
    new_m, new_v). The idle decays are ``pow(b, idle)``, as the JAX
    package's row form computes them."""
    g = g_rows.float()
    idle = emb_ops.trailing_dims((count - tau_rows).float(), g.dim())
    m = torch.pow(b1, idle) * m_rows + (1.0 - b1) * g
    v = torch.pow(b2, idle) * v_rows + (1.0 - b2) * (g * g)
    bc1, bc2 = _bias_corrections(count, b1, b2)
    m_hat = m / bc1
    v_hat = v / bc2
    new_rows = rows0.float() - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return new_rows.to(rows0.dtype), m, v


@torch.no_grad()
def sparse_adam_masked(table: torch.Tensor, g_rows: torch.Tensor,
                       touched: torch.Tensor, oe: EmbedAdamEntry, count: int,
                       *, lr: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, decay=None) -> None:
    """Lazy Adam as a masked TABLE sweep, IN PLACE on ``table`` and ``oe``:
    the per-row math of :func:`sparse_adam_rows` under ``touched``, and
    untouched rows keep their exact bits (a ``where``, not a blend).
    ``g_rows`` is table-shaped (junk on untouched rows). ``decay``: the
    precomputed ``(b1^idle, b2^idle)`` [R] pair shared by every table of
    the plane; by default ``pow`` of the table's own idle counts."""
    g = g_rows.float()
    if decay is None:
        idle = (count - oe.tau).float()
        decay = (torch.pow(b1, idle), torch.pow(b2, idle))
    pw1, pw2 = (emb_ops.trailing_dims(d, g.dim()) for d in decay)
    m = pw1 * oe.m + (1.0 - b1) * g
    v = pw2 * oe.v + (1.0 - b2) * (g * g)
    bc1, bc2 = _bias_corrections(count, b1, b2)
    new_rows = table.float() - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    keep = emb_ops.trailing_dims(touched, g.dim())
    table.copy_(torch.where(keep, new_rows.to(table.dtype), table))
    oe.m.copy_(torch.where(keep, m, oe.m))
    oe.v.copy_(torch.where(keep, v, oe.v))
    oe.tau.copy_(torch.where(touched, torch.full((), count, dtype=oe.tau.dtype,
                                                 device=oe.tau.device),
                             oe.tau))


@torch.no_grad()
def sparse_apply_rows(rows0: torch.Tensor, g_rows: torch.Tensor,
                      entry: emb_ops.PlanEntry, oe: EmbedAdamEntry,
                      count: int, *, lr: float,
                      table: torch.Tensor) -> None:
    """One table's sparse-Adam transaction, IN PLACE: gather the lazy
    slots at the plan's uids, :func:`sparse_adam_rows`, and write the
    three row sets and the ``tau`` stamps back (``scatter_rows`` /
    ``set_rows_scalar``: fill slots dropped)."""
    new_rows, new_m, new_v = sparse_adam_rows(
        rows0, g_rows, emb_ops.gather_rows(oe.m, entry),
        emb_ops.gather_rows(oe.v, entry), emb_ops.gather_rows(oe.tau, entry),
        count, lr=lr)
    emb_ops.scatter_rows(table, entry, new_rows)
    emb_ops.scatter_rows(oe.m, entry, new_m)
    emb_ops.scatter_rows(oe.v, entry, new_v)
    emb_ops.set_rows_scalar(oe.tau, entry, count)


def build_optimizer(cfg: Config, *, world_size: int = 1):
    """The configured optimizer, lr scaled by the data-parallel world size
    under ``scale_lr_by_world`` (world is 1 on one device)."""
    lr = cfg.learning_rate
    if cfg.scale_lr_by_world and world_size > 1:
        lr = lr * world_size
    name = cfg.optimizer.lower()
    if name == "adam":
        return Adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    if name == "adagrad":
        return Adagrad(lr, initial_accumulator_value=1e-8)
    if name in ("momentum", "sgd"):
        return Sgd(lr, momentum=0.95 if name == "momentum" else None)
    if name == "ftrl":
        return Ftrl(lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

