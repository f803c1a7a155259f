"""FM second-order interaction op (port of ``deepfm_tpu.ops.fm``).

The O(F*K) factorization-machine identity:

    y_v[b] = 0.5 * sum_k [ (sum_f xv[b,f,k])^2 - sum_f xv[b,f,k]^2 ]

``fm_interaction`` is the plain formulation that ``fm_block`` takes when
``use_pallas`` is off; ``ops.fused_fm`` computes first + second order in
one hand-written CUDA pass. ``masked_softmax`` is the sequence models'
attention normalizer (DIN and BST target attention).
"""

from __future__ import annotations

import torch


def fm_interaction(xv: torch.Tensor) -> torch.Tensor:
    """xv: [B, F, K] = embeddings * feature values. Returns [B]."""
    sum_sq = torch.square(torch.sum(xv, dim=1))      # [B, K]
    sq_sum = torch.sum(torch.square(xv), dim=1)      # [B, K]
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=1)   # [B]


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to the positions where ``mask > 0``,
    with exact ZEROS, not NaN, on a fully masked row (an empty history).

    Masked scores are replaced by the dtype's most negative finite value
    before the max and the exp, so a fully masked row shifts to zeros
    (never ``scores - sentinel``, whose exp would overflow), and the empty
    normalizer is resolved with ``where(denom > 0, num / denom, 0)``; the
    gradient through such a row is zero and finite. ``mask`` broadcasts
    against ``scores``."""
    valid = (mask > 0).to(scores.dtype)
    neg = torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                     device=scores.device)
    masked = torch.where(valid > 0, scores, neg)
    shifted = masked - torch.amax(masked, dim=dim, keepdim=True)
    num = torch.exp(shifted) * valid
    denom = torch.sum(num, dim=dim, keepdim=True)
    ok = denom > 0
    one = torch.ones((), dtype=scores.dtype, device=scores.device)
    return torch.where(ok, num / torch.where(ok, denom, one),
                       torch.zeros((), dtype=scores.dtype,
                                   device=scores.device))
