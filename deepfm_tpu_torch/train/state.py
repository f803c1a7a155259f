"""Train state: step, params, optimizer state, model (BN) state and the
dropout generator (port of ``deepfm_tpu.train.state``).

The JAX ``TrainState`` is an immutable pytree that each step replaces. The
port's is a mutable container of tensors that each step updates in place:
``params`` are leaf tensors that require grad, ``model_state`` holds the BN
running statistics, ``opt_state`` the optimizer's slots
(``train.optimizers``), ``rng`` the ``torch.Generator`` that draws dropout
masks on the params' device, and ``step`` a host-side int, so reading it
never waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    model_state: Dict[str, torch.Tensor]
    rng: torch.Generator

    def to_dict(self) -> Dict[str, Any]:
        """A checkpointable snapshot on the CPU (tensors copied), with the
        generator's state as a byte tensor."""
        return {
            "step": int(self.step),
            "params": _to_cpu(self.params),
            "opt_state": _to_cpu(self.opt_state),
            "model_state": _to_cpu(self.model_state),
            "rng": self.rng.get_state(),
        }

    def load_dict(self, d: Dict[str, Any]) -> "TrainState":
        """Copy a :meth:`to_dict` snapshot into this state's tensors, in
        place (shapes must match); returns self."""
        self.step = int(d["step"])
        _copy_into(self.params, d["params"], "params")
        self.opt_state = _copy_into(self.opt_state, d["opt_state"],
                                    "opt_state")
        _copy_into(self.model_state, d["model_state"], "model_state")
        self.rng.set_state(d["rng"])
        return self


def _is_record(tree: Any) -> bool:
    """A NamedTuple of slots (the sparse update's ``EmbedAdamEntry``)."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _to_cpu(tree: Any) -> Any:
    """CPU copies of the tensors; NamedTuples become dicts of their fields,
    so ``torch.load(weights_only=True)`` reads the snapshot back."""
    if _is_record(tree):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _copy_into(dst: Any, src: Any, where: str) -> Any:
    """Copy ``src`` into ``dst`` tensor by tensor; non-tensor leaves (the
    Adam step counts) are taken from ``src``, and a NamedTuple's fields
    from the dict :func:`_to_cpu` made of it. Returns the updated ``dst``."""
    if _is_record(dst):
        fields = _copy_into(dst._asdict(), src, where)
        return type(dst)(**fields)
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise ValueError(
                f"checkpoint {where} keys {sorted(src) if isinstance(src, dict) else src!r} "
                f"do not match this run's {sorted(dst)}")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], f"{where}.{k}")
        return dst
    if isinstance(dst, torch.Tensor):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"checkpoint {where} has shape {tuple(src.shape)}, this run "
                f"{tuple(dst.shape)}: the model config differs from the one "
                "that wrote the checkpoint")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    return src
