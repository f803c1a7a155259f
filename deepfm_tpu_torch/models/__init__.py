"""Model registry. Only DeepFM is ported so far; every other model of the
JAX zoo (and the multi-task wrapper) raises "not yet ported"."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from .deepfm import DeepFM  # noqa: F401

_REGISTRY = {
    "deepfm": DeepFM,
}


def registered_models():
    """Ported single-task model names."""
    return sorted(_REGISTRY)


def get_model(cfg: Config, *, device="cuda",
              generator: Optional[torch.Generator] = None) -> DeepFM:
    if cfg.num_tasks > 1:
        raise NotImplementedError(
            "multi-task models are not yet ported to deepfm_tpu_torch")
    cls = _REGISTRY.get(cfg.model)
    if cls is None:
        raise NotImplementedError(
            f"model {cfg.model!r} is not yet ported to deepfm_tpu_torch; "
            f"ported: {registered_models()}")
    return cls(cfg, device=device, generator=generator)
