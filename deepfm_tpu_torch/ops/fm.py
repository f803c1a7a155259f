"""FM second-order interaction op (port of ``deepfm_tpu.ops.fm``).

The O(F*K) factorization-machine identity:

    y_v[b] = 0.5 * sum_k [ (sum_f xv[b,f,k])^2 - sum_f xv[b,f,k]^2 ]

``fm_interaction`` is the plain formulation that ``fm_block`` takes when
``use_pallas`` is off; ``ops.fused_fm`` computes first + second order in
one hand-written CUDA pass.
"""

from __future__ import annotations

import torch


def fm_interaction(xv: torch.Tensor) -> torch.Tensor:
    """xv: [B, F, K] = embeddings * feature values. Returns [B]."""
    sum_sq = torch.square(torch.sum(xv, dim=1))      # [B, K]
    sq_sum = torch.sum(torch.square(xv), dim=1)      # [B, K]
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=1)   # [B]
