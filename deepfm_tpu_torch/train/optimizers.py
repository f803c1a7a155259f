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

and the step is ``p = p + (-lr) * u``. Beside them, ``exact_adagrad`` is
the published Adagrad that MLPerf's DLRM-DCNv2 trains with (FBGEMM's exact
Adagrad for its tables, ``torch.optim.Adagrad`` for the rest): the
accumulator starts at 0 and eps (1e-8) is added outside the square root,
    acc = acc + g^2;  u = g / (sqrt(acc) + eps).
These update every row of every table each step (the dense path); with
``--embedding_update sparse`` the embedding tables take the lazy Adam or,
under ``exact_adagrad``, its row form (both at the end of this module)
instead.
Updates are written in place with ``torch._foreach_*`` over the parameter
list, under ``torch.no_grad()``.

State is a plain dict of tensors keyed by parameter name (plus the step
count ``count`` as a Python int for Adam, whose bias correction is computed
on the host in float32), so it checkpoints with ``torch.save``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .. import _native
from ..config import Config
from ..obs import trace as trace_lib
from ..ops import embedding as emb_ops
from ..ops import embedding_kernels as ek

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


class ExactAdagrad:
    """The published Adagrad: ``acc = acc + g^2``, ``u = g / (sqrt(acc) +
    eps)``, the accumulator from 0. Exact where a gradient is zero: the
    parameter and its accumulator stay as they are."""

    def __init__(self, lr: float, *, eps: float = 1e-8):
        self.lr, self.eps = lr, eps

    def init(self, params: Params) -> dict:
        return {"sum_of_squares": _zeros(params)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: dict) -> None:
        ps, gs, accs = _lists(params, grads, state["sum_of_squares"])
        torch._foreach_add_(accs, torch._foreach_mul(gs, gs))
        den = torch._foreach_sqrt(accs)
        torch._foreach_add_(den, self.eps)
        _apply_step(ps, torch._foreach_div(gs, den), self.lr)


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


# ---------------------------------------------------------------------------
# Sparse (touched-rows-only) exact Adagrad
# ---------------------------------------------------------------------------
#
# A row no id touches has a zero gradient, under which ``ExactAdagrad``
# moves neither the row nor its accumulator: the row form below is the
# dense optimizer's step, with no correction for idle steps. On the card
# :func:`sparse_adagrad_tables` runs it as one hand-written kernel over
# every table (``csrc/optimizer.cu``: each touched row's gradient,
# accumulator and value read once, the last two written back), and
# :func:`sparse_adagrad_apply_tables` is its plain version (foreach ops and
# ``index_add_``), bit for bit the same.


def embed_adagrad_init(table: torch.Tensor) -> torch.Tensor:
    """A table's accumulator: float32 zeros like it."""
    return torch.zeros_like(table, dtype=torch.float32)


@torch.no_grad()
def sparse_adagrad_apply_tables(g_rows: List[torch.Tensor],
                                index: List[torch.Tensor],
                                accs: List[torch.Tensor], *, lr: float,
                                eps: float,
                                tables: List[torch.Tensor]) -> None:
    """Every table's sparse exact-Adagrad step, IN PLACE: ``g_rows`` [N, ...]
    are the gradients of the rows at ``index`` (``ops.embedding.
    spread_index`` of the plan: real slots at unique rows, fill slots with a
    zero gradient), ``ExactAdagrad``'s arithmetic over every table at once
    (foreach ops), then the step and the squared gradient added into each
    table and accumulator at ``index``. Each row takes one add of a nonzero
    value at most (the fill slots add zeros), so the adds give the rows
    ``ExactAdagrad`` gives, whatever their order."""
    g = [x.float() for x in g_rows]
    acc_rows = [a.index_select(0, i) for a, i in zip(accs, index)]
    g2 = torch._foreach_mul(g, g)
    torch._foreach_add_(acc_rows, g2)
    den = torch._foreach_sqrt(acc_rows)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(g, den)
    torch._foreach_mul_(u, -lr)
    for table, acc, i, du, dg in zip(tables, accs, index, u, g2):
        table.index_add_(0, i, du.to(table.dtype))
        acc.index_add_(0, i, dg)


#: Tables one ``dfm_sparse_adagrad`` launch serves (``csrc/optimizer.cu``
#: ``kMaxTables``).
ADAGRAD_MAX_TABLES = 32

#: ``dfm_sparse_adagrad`` launches, raised by one where
#: :func:`sparse_adagrad_tables` launches the kernel.
adagrad_launches = 0
_count_lock = threading.Lock()


def _check_sparse_adagrad(g_rows: List[torch.Tensor],
                          uids: List[torch.Tensor], accs: List[torch.Tensor],
                          tables: List[torch.Tensor]) -> None:
    """What the kernel takes: 1 to ``ADAGRAD_MAX_TABLES`` tables of one
    width K (a 1-D table is K = 1), each float32 table and accumulator
    [rows(, K)], gradient rows [N(, K)] and int32 uids [N], contiguous, on
    one device."""
    t = len(tables)
    if not 1 <= t <= ADAGRAD_MAX_TABLES or not (
            len(g_rows) == len(uids) == len(accs) == t):
        raise ValueError(
            f"a sparse Adagrad launch serves 1 to {ADAGRAD_MAX_TABLES} "
            f"tables with one gradient, uids and accumulator each; got "
            f"{len(tables)} tables, {len(g_rows)} gradients, {len(uids)} "
            f"uids, {len(accs)} accumulators")
    width = tables[0].shape[1:]
    for g, u, a, tab in zip(g_rows, uids, accs, tables):
        if (tab.dim() not in (1, 2) or tab.shape[1:] != width
                or a.shape != tab.shape or u.dim() != 1
                or g.shape != u.shape + width):
            raise ValueError(
                f"sparse Adagrad expects tables and accumulators [rows(,K)] "
                f"of one K, uids [N] and gradients [N(,K)]; got table "
                f"{tuple(tab.shape)}, accumulator {tuple(a.shape)}, uids "
                f"{tuple(u.shape)}, gradient {tuple(g.shape)}")
    every = (*g_rows, *uids, *accs, *tables)
    if any(x.device != tables[0].device for x in every):
        raise ValueError("sparse Adagrad inputs lie on different devices")
    if (any(x.dtype != torch.float32 for x in (*g_rows, *accs, *tables))
            or any(u.dtype != torch.int32 for u in uids)):
        raise TypeError("the sparse Adagrad kernel takes float32 tables, "
                        "accumulators and gradients and int32 uids")
    if not all(x.is_contiguous() for x in every):
        raise ValueError("the sparse Adagrad kernel needs contiguous inputs")


def _launch_sparse_adagrad(g_rows: List[torch.Tensor],
                           uids: List[torch.Tensor],
                           accs: List[torch.Tensor], *, lr: float,
                           eps: float, tables: List[torch.Tensor]) -> None:
    """One ``dfm_sparse_adagrad`` launch for every table; while tracing is
    on, the launch is counted in the open span's ``adagrad_launches``."""
    global adagrad_launches
    _check_sparse_adagrad(g_rows, uids, accs, tables)
    t = len(tables)
    k = 1 if tables[0].dim() == 1 else tables[0].shape[1]
    ptrs = [x.data_ptr() for parts in zip(g_rows, uids, tables, accs)
            for x in parts]
    lib = _native.load("optimizer")
    dev = tables[0].device
    with torch.cuda.device(dev):
        err = lib.dfm_sparse_adagrad(
            (ctypes.c_void_p * (4 * t))(*ptrs),
            (ctypes.c_int64 * t)(*(u.shape[0] for u in uids)),
            (ctypes.c_int64 * t)(*(tab.shape[0] for tab in tables)), t, k,
            lr, eps, torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "sparse Adagrad")
    with _count_lock:
        adagrad_launches += 1
    trace_lib.add_counts(lambda: {"adagrad_launches": 1})


def adagrad_leg(mode: str, device: torch.device) -> str:
    """``"kernel"`` where :func:`sparse_adagrad_tables` launches
    ``dfm_sparse_adagrad`` (the ``auto`` and ``pallas`` modes on a CUDA
    device), else ``"plain"``."""
    return ("kernel" if ek.resolve(mode, "adagrad") == "kernel"
            and device.type == "cuda" else "plain")


@torch.no_grad()
def sparse_adagrad_tables(g_rows: List[torch.Tensor],
                          uids: List[torch.Tensor], accs: List[torch.Tensor],
                          *, lr: float, eps: float,
                          tables: List[torch.Tensor],
                          mode: str = "auto") -> None:
    """Every table's sparse exact-Adagrad step, IN PLACE, through the leg
    ``ek.resolve(mode, "adagrad")`` picks: ``g_rows[t]`` [N, ...] are the
    gradients of the plan's slots ``uids[t]`` (int32 [N]: touched rows,
    then fill slots at the table's row count, whose gradient is zero).
    The kernel leg (``auto``, ``pallas``) makes one ``dfm_sparse_adagrad``
    launch for up to ``ADAGRAD_MAX_TABLES`` tables on CUDA tensors, and
    raises where it cannot; the ``xla`` and ``off`` legs, and CPU tensors,
    take :func:`sparse_adagrad_apply_tables` at the uids' spread index
    (fill slot s at row s mod rows). Both give the same bits."""
    if not tables or not len(g_rows) == len(uids) == len(accs) == len(
            tables):
        raise ValueError(f"sparse Adagrad takes one gradient, uids and "
                         f"accumulator a table; got {len(tables)} tables, "
                         f"{len(g_rows)} gradients, {len(uids)} uids, "
                         f"{len(accs)} accumulators")
    if adagrad_leg(mode, tables[0].device) == "kernel":
        for s in range(0, len(tables), ADAGRAD_MAX_TABLES):
            part = slice(s, s + ADAGRAD_MAX_TABLES)
            _launch_sparse_adagrad(g_rows[part], uids[part], accs[part],
                                   lr=lr, eps=eps, tables=tables[part])
        return
    index = []
    for u, tab in zip(uids, tables):
        rows = tab.shape[0]
        spread = torch.remainder(torch.arange(
            u.shape[0], dtype=u.dtype, device=u.device), rows)
        index.append(torch.where(u < rows, u, spread))
    sparse_adagrad_apply_tables(g_rows, index, accs, lr=lr, eps=eps,
                                tables=tables)


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
    if name == "exact_adagrad":
        return ExactAdagrad(lr, eps=1e-8)
    if name in ("momentum", "sgd"):
        return Sgd(lr, momentum=0.95 if name == "momentum" else None)
    if name == "ftrl":
        return Ftrl(lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

