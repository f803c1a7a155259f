"""The benchmark's traffic generator: CTR columns and initial weights made
on the device from a seed.

A frozen copy, kept beside the benchmark so that later changes to the
program cannot move the yardstick. The layout is the Criteo feature map
of the reference recipe's LibSVM input: the first ``integer_fields``
fields are Criteo's integer features, each one id of its own whose value
carries the number (here N(0, 1), a standardised count); the other
fields are categorical, each id drawn uniformly from the field's own
slice of the rest of the vocabulary (equal slices), value 1. The label
model is the one of the port's ``data/libsvm.py:generate_synthetic_ctr``:
a hidden weight per vocabulary id drawn N(0, 1) from a fixed hidden seed,
and ``label ~ Bernoulli(sigmoid(0.5 * sum_f hidden_w[id_f] * val_f))``.

Everything is drawn with ``torch.Generator``s on the given device, in
blocks of ``CHUNK`` rows. The same seed gives the same columns on the
same device.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

#: The hidden label model's seed (``generate_synthetic_ctr``'s default):
#: one ground truth for every run.
HIDDEN_SEED = 12345
#: Rows drawn per block: bounds the draw's temporaries on the device.
CHUNK = 1 << 22


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for one named stream of a run's ``seed``
    (any whole number, negative or beyond 64 bits included)."""
    words = [int(seed) & (2**32 - 1), (int(seed) >> 32) & (2**32 - 1),
             int(seed < 0), *[int(t) for t in tags]]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, device, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *tags))


# Stream tags: one per use of the seed.
DATA, WEIGHTS, ORDERS = 1, 3, 4


def slice_size(vocab: int, fields: int, integer_fields: int) -> int:
    """Ids in each categorical field's slice of the vocabulary."""
    return (vocab - integer_fields) // (fields - integer_fields)


def make_columns(traffic: Dict, *, vocab: int, fields: int, records: int,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """``{"label": [n] float32, "ids": [n, F] int32, "vals": [n, F]
    float32}`` on ``device``: ``records`` rows of the run ``seed``. Field
    ``f < I`` (``I = traffic["integer_fields"]``) is id ``f``; field
    ``f >= I`` draws from ``[I + (f - I) * S, I + (f - I + 1) * S)``."""
    dev = torch.device(device)
    n_int = int(traffic["integer_fields"])
    n_cat = fields - n_int
    s_ = slice_size(vocab, fields, n_int)
    g = generator(seed, dev, DATA)
    hidden_w = torch.randn((vocab,), device=dev, generator=torch.Generator(
        device=dev).manual_seed(HIDDEN_SEED))
    base = n_int + torch.arange(n_cat, device=dev, dtype=torch.int64) * s_
    ids = torch.empty((records, fields), dtype=torch.int32, device=dev)
    ids[:, :n_int] = torch.arange(n_int, dtype=torch.int32, device=dev)
    vals = torch.ones((records, fields), dtype=torch.float32, device=dev)
    label = torch.empty((records,), dtype=torch.float32, device=dev)
    for a in range(0, records, CHUNK):
        b = min(a + CHUNK, records)
        ids[a:b, n_int:] = torch.randint(
            0, s_, (b - a, n_cat), generator=g, device=dev) + base
        vals[a:b, :n_int] = torch.randn((b - a, n_int), generator=g,
                                        device=dev)
        logit = 0.5 * torch.sum(hidden_w[ids[a:b].long()] * vals[a:b], dim=1)
        label[a:b] = (torch.rand((b - a,), generator=g, device=dev)
                      < torch.sigmoid(logit)).to(torch.float32)
    return {"label": label, "ids": ids, "vals": vals}


def _fans(shape) -> tuple:
    if len(shape) == 1:
        return shape[0], shape[0]
    return shape[-2], shape[-1]


def make_weights(shapes: Dict[str, Iterable[int]], *, seed: int, device,
                 real_rows: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Initial float32 weights for the leaves ``shapes`` (name -> shape):
    the tables (``real_rows`` names them, with their real row counts; rows
    past them are zero) glorot-normal, 2-D tower weights glorot-uniform,
    every 1-D leaf that is no table zero. Two large draws, one normal and
    one uniform, sliced."""
    dev = torch.device(device)
    g = generator(seed, dev, WEIGHTS)
    shapes = {k: tuple(int(x) for x in v) for k, v in shapes.items()}
    tables = [k for k in shapes if k in real_rows]
    mats = [k for k in shapes if k not in real_rows and len(shapes[k]) == 2]
    n_norm = sum(real_rows[k] * int(np.prod(shapes[k][1:])) for k in tables)
    n_unif = sum(int(np.prod(shapes[k])) for k in mats)
    normal = torch.randn((n_norm,), generator=g, device=dev)
    unif = torch.rand((n_unif,), generator=g, device=dev) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k in tables:
        shp = shapes[k]
        real = (real_rows[k],) + shp[1:]
        n = int(np.prod(real))
        fan_in, fan_out = _fans(real)
        t = torch.zeros(shp, device=dev)
        t[:real_rows[k]] = normal[off:off + n].view(real) * float(
            np.sqrt(2.0 / (fan_in + fan_out)))
        out[k] = t
        off += n
    off = 0
    for k in mats:
        shp = shapes[k]
        n = int(np.prod(shp))
        fan_in, fan_out = _fans(shp)
        out[k] = unif[off:off + n].view(shp) * float(
            np.sqrt(6.0 / (fan_in + fan_out)))
        off += n
    for k, shp in shapes.items():
        if k not in out:
            out[k] = torch.zeros(shp, device=dev)
    return out
