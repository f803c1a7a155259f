"""Model zoo registry: the single-task graphs and the multi-task wrapper
(port of ``deepfm_tpu.models``).

``get_model`` is the one dispatch point: a config with more than one task
(``--tasks ctr,cvr``) builds the multi-task model (``--multitask``
architecture over the shared embedding stage); otherwise ``cfg.model``
picks a single-task graph from the registry.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import Config
from .dcnv2 import DCNv2  # noqa: F401
from .deepfm import DeepFM  # noqa: F401
from .graph import DLRM  # noqa: F401
from .multitask import MultiTaskModel  # noqa: F401
from .sequence import GraphBST, GraphDIN  # noqa: F401
from .widedeep import WideDeep  # noqa: F401

_REGISTRY = {
    "deepfm": DeepFM,
    "widedeep": WideDeep,
    "dcnv2": DCNv2,
    "dlrm": DLRM,
    "din": GraphDIN,
    "bst": GraphBST,
}

CtrModel = Union[DeepFM, WideDeep, DCNv2, DLRM, GraphDIN, GraphBST,
                 MultiTaskModel]


def registered_models():
    """Registered single-task model names (the ``--model`` whitelist)."""
    return sorted(_REGISTRY)


def get_model(cfg: Config, *, device="cuda",
              generator: Optional[torch.Generator] = None) -> CtrModel:
    if cfg.num_tasks > 1:
        return MultiTaskModel(cfg, device=device, generator=generator)
    try:
        cls = _REGISTRY[cfg.model]
    except KeyError:
        raise ValueError(f"unknown model {cfg.model!r}; have "
                         f"{sorted(_REGISTRY)}") from None
    return cls(cfg, device=device, generator=generator)
