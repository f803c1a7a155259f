"""DLRM-DCNv2 (``--model dlrm_dcnv2``) with the published Adagrad
(``exact_adagrad``): its multi-hot rows, its weights made leaf by leaf from
the seed, its step shapes, the first gradient from Adagrad's accumulator,
and the plain reference (``perfbench/reference/dlrm_dcnv2.py``). The
functions are the ones ``perfbench/families/__init__.py`` names.

The rows (``columns``): the 13 dense columns hold ``log(1 + c)`` of a
count c drawn geometric on {0, 1, ...} with mean ``dense_count_mean``,
by inversion of a uniform draw (their ids, 0-12,
reach no table); then each feature's bag of its fixed hotness, ids uniform
over the rows of its table, values 1. Labels come from a hidden logistic
model with weights N(0, 1) drawn from ``gen.HIDDEN_SEED``'s streams:

    z = 0.3 * (sum_f mean_j h_f[ids_f[:, j]] + sum_d w_d * (v_d - 2.5))
    label ~ Bernoulli(sigmoid(z))

The weights: leaf i of the sorted leaf names from a generator of its own
(stream ``gen.WEIGHTS``, i), so any one leaf can be made again alone: each
table uniform in +-sqrt(1 / rows) of its rows on this card (torchrec's
default on a whole table; twice its bound on a quarter shard of a split
one), 2-D weights glorot-uniform, biases zero. ``weights`` and ``hold`` return a mapping
that makes a leaf when it is read: the tables (25.8 GiB) are never held
twice.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, Iterator, List

import numpy as np
import torch

from perfbench.core import compare
from perfbench.gen import traffic as gen
from perfbench.reference import dlrm_dcnv2 as ref

DENSE = ref.DENSE
TABLE = "embedding.t"
#: The hidden label model's streams of ``gen.HIDDEN_SEED``: the dense
#: weights', then one per table.
HIDDEN_DENSE, HIDDEN_TABLE = 100, 101
#: Rows summed a block when a table's accumulator is read.
SUM_ROWS = 1 << 20


def _ints(s: str) -> List[int]:
    return [int(x) for x in str(s).split(",") if x]


def _layout(flags: Dict):
    """(hotness, rows, each feature's first column)."""
    hot, rows = _ints(flags["feature_hotness"]), _ints(flags["table_rows"])
    starts = list(DENSE + np.cumsum([0] + hot[:-1]))
    return hot, rows, [int(s) for s in starts]


def columns(cell: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    t, flags = cell["traffic"], cell["config"]["flags"]
    dev = torch.device(device)
    hot, rows, starts = _layout(flags)
    n, fields = int(t["records_per_card"]), DENSE + sum(hot)
    g = gen.generator(seed, dev, gen.DATA)
    w_dense = torch.randn((DENSE,), device=dev, generator=gen.generator(
        gen.HIDDEN_SEED, dev, HIDDEN_DENSE))
    hidden = [torch.randn((r,), device=dev, generator=gen.generator(
        gen.HIDDEN_SEED, dev, HIDDEN_TABLE, f)) for f, r in enumerate(rows)]
    p = 1.0 / (1.0 + float(t["dense_count_mean"]))
    ids = torch.empty((n, fields), dtype=torch.int32, device=dev)
    ids[:, :DENSE] = torch.arange(DENSE, dtype=torch.int32, device=dev)
    vals = torch.ones((n, fields), dtype=torch.float32, device=dev)
    label = torch.empty((n,), dtype=torch.float32, device=dev)
    for a in range(0, n, gen.CHUNK):
        b = min(a + gen.CHUNK, n)
        # Geometric counts by inversion of u in [0, 1): always finite
        # (``geometric_`` returns inf for a uniform draw of exactly 0).
        u = torch.rand((b - a, DENSE), generator=g, device=dev)
        counts = torch.floor(torch.log1p(-u) / math.log1p(-p))
        vals[a:b, :DENSE] = torch.log1p(counts)
        z = (vals[a:b, :DENSE] - 2.5) @ w_dense
        for f, (h, r, s) in enumerate(zip(hot, rows, starts)):
            part = torch.randint(0, r, (b - a, h), generator=g, device=dev,
                                 dtype=torch.int32)
            ids[a:b, s:s + h] = part
            z += hidden[f][part.long()].mean(dim=1)
        label[a:b] = (torch.rand((b - a,), generator=g, device=dev)
                      < torch.sigmoid(0.3 * z)).to(torch.float32)
    return {"label": label, "ids": ids, "vals": vals}


def make_leaf(name: str, shape, index: int, seed: int,
              device) -> torch.Tensor:
    """Leaf ``name`` (the ``index``-th of the sorted leaf names) from its own
    stream of ``seed``."""
    dev = torch.device(device)
    shape = tuple(int(x) for x in shape)
    if len(shape) == 1 and not name.startswith(TABLE):
        return torch.zeros(shape, device=dev)
    g = gen.generator(seed, dev, gen.WEIGHTS, index)
    if name.startswith(TABLE):
        bound = math.sqrt(1.0 / shape[0])
    else:
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    out = torch.rand(shape, generator=g, device=dev)
    return out.mul_(2.0 * bound).sub_(bound)


class Leaves(Mapping):
    """The initial weights as a mapping that makes each leaf from the seed
    when it is read, on ``device``."""

    def __init__(self, shapes: Dict, seed: int, device):
        self._shapes = {k: tuple(v) for k, v in shapes.items()}
        self._index = {k: i for i, k in enumerate(sorted(self._shapes))}
        self._seed, self._device = seed, device

    def __getitem__(self, name: str) -> torch.Tensor:
        return make_leaf(name, self._shapes[name], self._index[name],
                         self._seed, self._device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._shapes)

    def __len__(self) -> int:
        return len(self._shapes)


def weights(cell: Dict, shapes: Dict, seed: int, device) -> Leaves:
    return Leaves(shapes, seed, device)


def hold(w0: Leaves, cell: Dict, seed: int) -> Leaves:
    """The same mapping: a leaf is made again when it is read."""
    return w0


def step_shapes(flags: Dict, batch: int, shapes: Dict) -> Dict:
    hot, _, _ = _layout(flags)
    k = int(flags["embedding_size"])
    bottom = [DENSE] + _ints(flags["bottom_layers"])
    d = (len(hot) + 1) * k
    top = [d] + _ints(flags["deep_layers"])
    rank, layers = int(flags["cross_rank"]), int(flags["cross_layers"])

    def chain(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))

    # Multiply-adds an example: the bottom MLP, the cross network's two
    # products a layer, the top MLP and its [d, 1] head; a training step
    # is three times the forward's, two operations a multiply-add.
    macs = chain(bottom) + layers * 2 * d * rank + chain(top) + top[-1]
    return {"batch": batch, "dim": k, "hotness": hot, "bottom": bottom,
            "cross_dim": d, "cross_rank": rank, "cross_layers": layers,
            "top": top,
            "compute_bytes": 2 if flags["compute_dtype"] == "bfloat16" else 4,
            "flops_per_example": 6 * macs}


def _sum64(acc: torch.Tensor) -> float:
    """The float64 sum of a float32 tensor, a block of rows at a time."""
    return sum(float(acc[a:a + SUM_ROWS].double().sum())
               for a in range(0, acc.shape[0], SUM_ROWS))


def first_grad_norms(opt_state: Dict) -> Dict[str, float]:
    """Adagrad's accumulator starts at 0, so after the first step it holds
    each entry's first gradient squared: the norm is the root of its sum."""
    out = {k: math.sqrt(_sum64(acc))
           for k, acc in opt_state["base"]["sum_of_squares"].items()}
    for name, tables in opt_state["embed"].items():
        out.update({f"{name}.{key}": math.sqrt(_sum64(acc))
                    for key, acc in tables.items()})
    return out


def reference(cell: Dict, held: Leaves, batches: List[Dict[str, torch.Tensor]],
              device, *, quant: bool = False, rows=None) -> Dict:
    """The reference over each table's rows that the batches touch: each
    table made again from the seed, those rows kept, the batches' ids
    turned into their places among them."""
    flags = cell["config"]["flags"]
    hot, _, starts = _layout(flags)
    batches = [dict(b, ids=b["ids"].long().clone()) for b in batches]
    params = {k: held[k].to(device) for k in held
              if not k.startswith(TABLE)}
    for f, (h, s) in enumerate(zip(hot, starts)):
        touched = torch.unique(torch.cat(
            [b["ids"][:, s:s + h].reshape(-1) for b in batches]))
        params[f"{TABLE}{f}"] = held[f"{TABLE}{f}"].to(device)[touched]
        for b in batches:
            b["ids"][:, s:s + h] = torch.searchsorted(
                touched, b["ids"][:, s:s + h].contiguous())
    out = ref.train_steps(params, batches, hot,
                          lr=float(flags["learning_rate"]), quant=quant,
                          rows=rows)
    return {"losses": out["losses"], "grad1": compare.norms(out["grad1"]),
            "change": compare.norms(out["change"])}
