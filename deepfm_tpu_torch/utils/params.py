"""Weight carry-over from the JAX package.

``params_from_jax`` takes the JAX package's ``(params, model_state)``
nested dicts of numpy arrays (``jax.tree.map(np.asarray, ...)`` of a
``TrainState``) and returns the port's flat ``{name: tensor}`` dicts, named
as the port's modules name them (``tower.layers.0.w``, ``bn.0.mean``, ...):

    params, state = params_from_jax(jax_params, jax_model_state)
    model.load_state_dict({**params, **state})

No layout change is needed: the port keeps the JAX tower layout
(``w`` [d_in, d_out], applied as ``x @ w``) and ``fm_b`` as a vector
(``[1]``, or ``[T]`` for a multi-task model), and every zoo model names its
modules as the JAX trees nest: DCN-v2's ``cross.<i>.{w|u,v,b}`` and
``head.{w,b}``; the multi-task ``bottom.*``, ``experts.<i>.*``,
``gates.<t>.w``, ``heads.<t>.{w,b}`` and ``towers.<t>.*``; DIN's
``att.{w1,b1,w2,b2}`` and BST's ``att.{pos,target_pos,wq,wk,wv}``. The
model states ``{"bn": [...]}``, ``{"bottom": {"bn": ...}}``, ``{"experts":
[...]}`` and ``{"towers": [...]}`` flatten onto the BN buffers
(``bn.0.mean``, ``experts.1.bn.0.var``, ...). ``opt_state_from_jax`` carries optax's Adam state over the same
way, so a port run can resume a JAX trajectory mid-way.
``tower_params_from_jax`` carries a ``TwinTower`` param tree (``emb``,
``user``, ``item``) into the port's ``TwinTower`` state. This module never
imports jax: numpy is the interchange.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..train.optimizers import EmbedAdamEntry


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


def tower_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``TwinTower`` param tree of numpy arrays (``{"emb": entry,
    "user": [{"w", "b"}, ...], "item": [...]}``) -> the port's
    ``TwinTower`` state dict (``emb`` or ``emb.t0``, ..., ``user.0.w``,
    ...) of CPU tensors."""
    return {k: _tensor(v) for k, v in flatten(tree).items()}


def opt_state_from_jax(opt_state: Any) -> Dict[str, Any]:
    """optax Adam state (``jax.tree.map(np.asarray, opt_state)`` of
    ``optax.adam``: a chain whose first element carries ``count``, ``mu``
    and ``nu``) -> the port's Adam state ``{"count": int, "mu": {...},
    "nu": {...}}`` of CPU tensors, named as the port's params.

    The sparse update's layout ``{"base": <optax Adam over the other
    params>, "embed": {name: {table: EmbedAdamEntry(m, v, tau)}}, "count":
    int32}`` comes over as the port's ``{"base": ..., "embed": {name:
    {table: EmbedAdamEntry}}, "count": int}`` (``tau`` stays int32)."""
    if isinstance(opt_state, dict) and "embed" in opt_state:
        return {"base": opt_state_from_jax(opt_state["base"]),
                "embed": {name: {key: EmbedAdamEntry(
                    m=_tensor(e.m), v=_tensor(e.v), tau=_tensor(e.tau))
                    for key, e in tables.items()}
                    for name, tables in opt_state["embed"].items()},
                "count": int(np.asarray(opt_state["count"]))}
    adam = opt_state
    while not hasattr(adam, "mu"):
        if not isinstance(adam, (list, tuple)) or not adam:
            raise ValueError("no optax Adam state (count/mu/nu) found")
        adam = adam[0]
    return {"count": int(np.asarray(adam.count)),
            "mu": {k: _tensor(v) for k, v in flatten(adam.mu).items()},
            "nu": {k: _tensor(v) for k, v in flatten(adam.nu).items()}}
