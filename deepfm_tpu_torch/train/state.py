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
from typing import Any, Dict, List, Tuple

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


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a state tree in a fixed order: dict keys in
    insertion order, a NamedTuple's fields in order."""
    if _is_record(tree):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, path + (k,))
        return out
    return [(path, tree)]


class StateSnapshot:
    """A copy of a :class:`TrainState` in preallocated buffers, for the
    non-finite guard's ``skip``: every tensor of the params, the optimizer
    state (base optimizer, lazy-Adam m/v/tau), and the model state, copied
    in one ``_foreach_copy_`` pass on the state's device; the host-side
    counts (``step``, the optimizers' ``count``) and the dropout generator's
    state kept beside them. :meth:`restore` copies all of it back into the
    state's own tensors, in place, so a restored state continues exactly as
    if the dispatch in between never ran. The buffers are allocated at the
    first :meth:`take` and reused while the state's layout stays the same.
    """

    def __init__(self) -> None:
        self._bufs: List[torch.Tensor] = []
        self._shapes: List[Tuple] = []
        self._scalars: List[Tuple[Tuple, Any]] = []
        self._step = 0
        self._rng = None

    @staticmethod
    def _split(state: TrainState):
        trees = (("params", state.params), ("opt_state", state.opt_state),
                 ("model_state", state.model_state))
        tensors, scalars = [], []
        for name, tree in trees:
            for path, leaf in _leaves(tree, (name,)):
                if isinstance(leaf, torch.Tensor):
                    tensors.append(leaf)
                else:
                    scalars.append((path, leaf))
        return tensors, scalars

    @property
    def nbytes(self) -> int:
        """Bytes one :meth:`take` copies."""
        return sum(b.numel() * b.element_size() for b in self._bufs)

    @torch.no_grad()
    def take(self, state: TrainState) -> None:
        tensors, self._scalars = self._split(state)
        shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        if shapes != self._shapes:
            self._bufs = [torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in tensors]
            self._shapes = shapes
        if tensors:
            torch._foreach_copy_(self._bufs, [t.detach() for t in tensors])
        self._step = int(state.step)
        self._rng = state.rng.get_state()

    @torch.no_grad()
    def restore(self, state: TrainState) -> TrainState:
        """Copy the snapshot back into ``state`` in place; returns it."""
        if self._rng is None:
            raise RuntimeError("restore before any take")
        tensors, _ = self._split(state)
        if [(t.shape, t.dtype, t.device) for t in tensors] != self._shapes:
            raise ValueError("the state's layout changed since the snapshot")
        if tensors:
            torch._foreach_copy_([t.detach() for t in tensors], self._bufs)
        for path, value in self._scalars:
            tree = state.opt_state if path[0] == "opt_state" else None
            if tree is None:
                raise ValueError(f"host value outside opt_state at {path}")
            for k in path[1:-1]:
                tree = tree[k]
            tree[path[-1]] = value
        state.step = self._step
        state.rng.set_state(self._rng)
        return state
