"""Weight carry-over from the JAX package.

``params_from_jax`` takes the JAX package's ``(params, model_state)``
nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)`` of a
``TrainState``) and returns the port's flat ``{name: tensor}`` dicts, named
as the port's modules name them (``tower.layers.0.w``, ``bn.0.mean``, ...):

    params, state = params_from_jax(jax_params, jax_model_state)
    model.load_state_dict({**params, **state})

No layout change is needed: the port keeps the JAX tower layout
(``w`` [d_in, d_out], applied as ``x @ w``) and ``fm_b`` as a ``[1]``
vector. This module never imports jax: numpy is the interchange.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/lists -> ``{"a.b.0.c": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _tensor(x: Any) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bf16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(params: Dict[str, Any], model_state: Dict[str, Any]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """JAX ``(params, model_state)`` of numpy arrays -> the port's
    ``(params, model_state)`` of CPU tensors, flat and dot-named."""
    return ({k: _tensor(v) for k, v in flatten(params).items()},
            {k: _tensor(v) for k, v in flatten(model_state).items()})
