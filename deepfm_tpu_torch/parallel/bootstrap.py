"""Multi-process bootstrap over ``torch.distributed`` (port of
``deepfm_tpu.parallel.bootstrap``): one process per GPU.

``dist_mode`` (Config):
  0 — one process; nothing to initialize.
  1 — a local cluster: processes rendezvous on ``coordinator_address``
      with an explicit ``num_processes``/``process_id`` (what
      ``deepfm_tpu_torch.fanout`` passes). ``host:port`` becomes a TCP
      store (``tcp://host:port``); an address that already names a scheme
      (``file:///path``, ``tcp://...``) is used as it is.
  2 — a managed cluster: ``env://``, the variables torchrun sets
      (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
      ``LOCAL_RANK``).

The default group runs NCCL for a CUDA device and gloo for the CPU; a
caller may name the backend (``backend="gloo"`` with CUDA tensors runs two
ranks on one card, which NCCL refuses). Host-side agreement (batch counts,
the resume position, the preemption flag, host names) goes through a gloo
group of its own on CPU tensors (the helpers below), so it never waits on
the card. Every group has a finite timeout (``DEEPFM_TPU_TORCH_DIST_
TIMEOUT_S``, default 300 s): a rank that dies before a collective fails
the others instead of hanging them.

"Chief" semantics (rank-0-only checkpoint, export and ``pred.txt``;
reference ``2-hvd-gpu/...py:365-368``) map to :func:`is_chief`.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config

TIMEOUT_ENV = "DEEPFM_TPU_TORCH_DIST_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 300.0

_CONTROL: Any = None          # the gloo group of host-side agreement
_LOCAL_RANK: Optional[int] = None
# Subgroups by rank list (``new_group`` is collective: every rank creates
# every group, in one order, including those it is not in).
_SUBGROUPS: Dict[Tuple[int, ...], Any] = {}


def timeout() -> datetime.timedelta:
    """The groups' timeout (``DEEPFM_TPU_TORCH_DIST_TIMEOUT_S``)."""
    raw = os.environ.get(TIMEOUT_ENV, "").strip()
    return datetime.timedelta(seconds=float(raw) if raw else DEFAULT_TIMEOUT_S)


def _init_method(address: str) -> str:
    if not address:
        raise ValueError("dist_mode=1 requires coordinator_address")
    return address if "://" in address else f"tcp://{address}"


def initialize(cfg: Config, *, device="cuda",
               backend: Optional[str] = None) -> None:
    """Idempotent process-group bootstrap per ``cfg.dist_mode``. On a CUDA
    device the process's card is selected first (``torch.cuda.set_device``
    with the local rank over the visible cards: 0 under ``fanout``, which
    gives each child one card)."""
    global _CONTROL, _LOCAL_RANK
    if cfg.dist_mode == 0 or dist.is_initialized():
        return
    if cfg.dist_mode not in (1, 2):
        raise ValueError(f"unknown dist_mode {cfg.dist_mode}")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    tmo = timeout()
    if cfg.dist_mode == 1:
        rank = cfg.process_id
        _LOCAL_RANK = rank % max(cfg.worker_per_host, 1)
        init = dict(init_method=_init_method(cfg.coordinator_address),
                    world_size=cfg.num_processes, rank=rank)
    else:
        _LOCAL_RANK = int(os.environ.get("LOCAL_RANK", "0"))
        init = dict(init_method="env://")
    if dev.type == "cuda":
        torch.cuda.set_device(_LOCAL_RANK % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=tmo, **init)
    _CONTROL = (dist.group.WORLD if dist.get_backend() == "gloo"
                else dist.new_group(backend="gloo", timeout=tmo))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host (0 in a single process)."""
    return _LOCAL_RANK if (_LOCAL_RANK is not None
                           and dist.is_initialized()) else 0


def is_chief() -> bool:
    """Rank-0 semantics: checkpoint, export and ``pred.txt`` only on the
    chief (reference rank-0-only model_dir, 2-hvd-gpu/...py:365-368)."""
    return process_index() == 0


def subgroup(ranks: Sequence[int]) -> Any:
    """The process group of ``ranks`` (created on first use, by every
    rank)."""
    key = tuple(ranks)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(list(key), timeout=timeout())
    return _SUBGROUPS[key]


def barrier() -> None:
    """Every rank waits here for the others (no-op in one process)."""
    if dist.is_initialized():
        dist.barrier(group=_CONTROL)


def allgather_ints(values: Sequence[int]) -> List[List[int]]:
    """Every rank's ``values`` (same length on each), in rank order."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if not dist.is_initialized():
        return [t.tolist()]
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_CONTROL)
    return [o.tolist() for o in out]


def broadcast_ints(values: Sequence[int], src: int = 0) -> List[int]:
    """``values`` of rank ``src`` on every rank."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if dist.is_initialized():
        dist.broadcast(t, src, group=_CONTROL)
    return t.tolist()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any."""
    return any(v[0] for v in allgather_ints([int(bool(flag))]))


def allgather_rows(local: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(every rank's ``local`` rows padded to the longest, stacked
    [world, n, ...]; each rank's row count)."""
    counts = np.asarray([c[0] for c in allgather_ints([len(local)])],
                        np.int64)
    padded = np.zeros((max(int(counts.max()), 1),) + local.shape[1:],
                      local.dtype)
    padded[:len(local)] = local
    if not dist.is_initialized():
        return padded[None], counts
    t = torch.from_numpy(padded)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_CONTROL)
    return np.stack([o.numpy() for o in out]), counts


def allgather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj, group=_CONTROL)
    return out


def destroy() -> None:
    """Tear the groups down (the end of a clean run)."""
    global _CONTROL, _LOCAL_RANK
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTROL = None
    _LOCAL_RANK = None
    _SUBGROUPS.clear()
