"""Embedding lookup for one device (port of the dense part of
``deepfm_tpu.ops.embedding``).

``lookup`` reproduces ``jnp.take``'s semantics, not ``torch.index_select``'s:
an id in ``[-V, 0)`` wraps to ``id + V``, and any other out-of-range id gives
a row of NaN. ``index_select`` would instead hit a device-side assert on the
card, which poisons the CUDA context for every later request of the
process; NaN rows make a bad id visible in that request's output alone.
"""

from __future__ import annotations

import math

import torch

# Vocab rows are padded to a multiple of this regardless of the mesh, so a
# table's shape (and every artifact) is the same on any power-of-two
# row-sharding up to 64-way (``deepfm_tpu.ops.embedding._VOCAB_PAD_MULTIPLE``).
_VOCAB_PAD_MULTIPLE = 64


def padded_vocab(feature_size: int, num_shards: int) -> int:
    """Round the vocabulary up to a multiple of 64 (and of ``num_shards``).

    Pad rows are zero-initialised and unreachable from real ids."""
    m = math.lcm(_VOCAB_PAD_MULTIPLE, max(num_shards, 1))
    return ((feature_size + m - 1) // m) * m


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` [V, ...] at integer ``ids`` [...].

    Returns [..., *table.shape[1:]] with ``jnp.take`` semantics (see the
    module docstring)."""
    v = table.shape[0]
    ids = ids.long()
    ok = (ids >= -v) & (ids < v)
    safe = torch.where(ok, torch.where(ids < 0, ids + v, ids),
                       torch.zeros((), dtype=ids.dtype, device=ids.device))
    out = table.index_select(0, safe.reshape(-1))
    out = out.reshape(*ids.shape, *table.shape[1:])
    ok = ok.reshape(*ids.shape, *([1] * (table.dim() - 1)))
    return torch.where(ok, out, torch.full((), float("nan"), dtype=out.dtype,
                                           device=out.device))
