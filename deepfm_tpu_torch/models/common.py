"""Shared model building blocks (the serving subset of
``deepfm_tpu.models.common``): initializers, the DNN tower in eval mode and
the monolithic embedding layout.

Behavioral parity with the JAX package:
  * Hidden layers: dense -> ReLU -> [BatchNorm]; BN runs from its running
    statistics, in float32 (eval mode). Dropout is a training-only op and
    comes with the training slice.
  * Tower weights keep the JAX layout, ``w`` is ``[d_in, d_out]`` applied
    as ``x @ w``, so a JAX param tree carries over without transposes
    (``utils.params.params_from_jax``).
  * Matmuls run in ``compute_dtype`` (bfloat16 by default) over float32
    params, rounding where the JAX package rounds: after each product and
    again after each bias add.
  * The output head (``[d, 1]``) is computed as a row-wise float32 dot
    product rounded to ``compute_dtype``: the same value as the JAX
    ``h @ w`` up to summation order, and independent of the batch size,
    so a padded serving bucket returns bit-identical real rows (BLAS picks
    a matrix-vector kernel whose sum order depends on the row count).

Initializers draw from an explicit ``torch.Generator``; they give other
numbers than ``jax.random`` for the same seed, so tests carry JAX weights
over instead of comparing inits.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import embedding as emb_ops


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    recep = 1
    for s in shape[:-2]:
        recep *= s
    return shape[-2] * recep, shape[-1] * recep


def _draw(fill, shape: Sequence[int], generator: Optional[torch.Generator],
          device: torch.device) -> torch.Tensor:
    """float32 tensor of ``shape`` on ``device``, drawn on the generator's
    device. On the ``meta`` device nothing is drawn (weights come from a
    later ``load_state_dict(..., assign=True)``)."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if generator is None:
        raise ValueError("initializing weights needs a torch.Generator")
    out = torch.empty(tuple(shape), dtype=torch.float32,
                      device=generator.device)
    fill(out, generator)
    return out.to(device)


def glorot_normal(shape: Sequence[int], *,
                  generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return _draw(lambda t, g: t.normal_(0.0, std, generator=g),
                 shape, generator, device)


def glorot_uniform(shape: Sequence[int], *,
                   generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return _draw(lambda t, g: t.uniform_(-limit, limit, generator=g),
                 shape, generator, device)


# ---------------------------------------------------------------------------
# BatchNorm (eval mode: running statistics)
# ---------------------------------------------------------------------------


def batch_norm(h32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Normalize h32 [B, D] (float32) with running ``mean``/``var``."""
    return (h32 - mean) * torch.rsqrt(var + eps) * scale + bias


class RunningStats(nn.Module):
    """One BN layer's running statistics: the model state ``bn[i]``."""

    def __init__(self, dim: int, *, device: torch.device):
        super().__init__()
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))


# ---------------------------------------------------------------------------
# DNN tower
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """One tower layer: ``w`` [d_in, d_out], ``b`` [d_out] and, with BN,
    ``bn_scale``/``bn_bias`` [d_out]."""

    def __init__(self, d_in: int, d_out: int, *, use_bn: bool,
                 generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(glorot_uniform((d_in, d_out),
                                             generator=generator,
                                             device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))
        if use_bn:
            self.bn_scale = nn.Parameter(torch.ones(d_out, device=device))
            self.bn_bias = nn.Parameter(torch.zeros(d_out, device=device))


class Tower(nn.Module):
    """Hidden stack (``layers``) plus the dense->1 head (``out``)."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int], *,
                 use_bn: bool, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        dims = [in_dim] + list(layer_sizes)
        self.layers = nn.ModuleList(
            Dense(d_in, d_out, use_bn=use_bn, generator=generator,
                  device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))
        self.out = Dense(dims[-1], 1, use_bn=False, generator=generator,
                         device=device)


def init_tower(in_dim: int, layer_sizes: Sequence[int], use_bn: bool, *,
               generator: Optional[torch.Generator],
               device: torch.device) -> Tuple[Tower, nn.ModuleList]:
    """Hidden stack + final dense->1. Returns (tower, bn running stats)."""
    tower = Tower(in_dim, layer_sizes, use_bn=use_bn, generator=generator,
                  device=device)
    bn = nn.ModuleList(RunningStats(d, device=device) for d in layer_sizes
                       ) if use_bn else nn.ModuleList()
    return tower, bn


def apply_hidden_stack(layers: nn.ModuleList, bn: nn.ModuleList,
                       x: torch.Tensor, *, use_bn: bool,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """dense->relu->[BN] stack in eval mode. x: [B, D_in] -> [B, D_last]."""
    h = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        h = h @ layer.w.to(compute_dtype) + layer.b.to(compute_dtype)
        h = torch.relu(h)
        if use_bn:
            h = batch_norm(h.float(), layer.bn_scale, layer.bn_bias,
                           bn[i].mean, bn[i].var).to(compute_dtype)
    return h


def apply_tower(tower: Tower, bn: nn.ModuleList, x: torch.Tensor, *,
                use_bn: bool, compute_dtype: torch.dtype) -> torch.Tensor:
    """Hidden stack + output head in eval mode. x: [B, D] -> [B] float32."""
    h = apply_hidden_stack(tower.layers, bn, x, use_bn=use_bn,
                           compute_dtype=compute_dtype)
    w = tower.out.w[:, 0].to(compute_dtype).float()
    out = torch.sum(h.float() * w, dim=1).to(compute_dtype)
    return (out + tower.out.b[0].to(compute_dtype)).float()


# ---------------------------------------------------------------------------
# Embedding schema: the monolithic layout
# ---------------------------------------------------------------------------


class EmbeddingSchema:
    """The monolithic embedding layout: one ``[padded_vocab, ...]`` table per
    embedding param. The hash-bucketed multi-table layout is not ported
    yet."""

    def __init__(self, cfg):
        if list(cfg.embedding_bucket_sizes):
            raise NotImplementedError(
                "hash-bucketed embedding tables (--embedding_buckets) are not "
                "yet ported to deepfm_tpu_torch")
        self.feature_size = int(cfg.feature_size)
        self.padded_vocab = emb_ops.padded_vocab(cfg.feature_size,
                                                 cfg.mesh_model)

    def init_entry(self, trailing: Tuple[int, ...], *,
                   generator: Optional[torch.Generator],
                   device: torch.device) -> torch.Tensor:
        """Glorot-normal over the REAL vocab, zero pad rows after it."""
        t = glorot_normal((self.feature_size, *trailing),
                          generator=generator, device=device)
        pad = self.padded_vocab - self.feature_size
        if pad:
            t = torch.cat([t, torch.zeros((pad, *trailing), dtype=t.dtype,
                                          device=device)])
        return t

    def lookup(self, entry: torch.Tensor,
               feat_ids: torch.Tensor) -> torch.Tensor:
        """[B,F,*trailing] gather, with ``jnp.take``'s out-of-range rules."""
        return emb_ops.lookup(entry, feat_ids)
