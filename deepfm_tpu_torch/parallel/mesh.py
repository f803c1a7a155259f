"""The data-parallel mesh over ``torch.distributed`` (port of the data axis
of ``deepfm_tpu.parallel.mesh``).

The JAX package lays a ``('data', 'model')`` device mesh; its data axis
averages the gradients (``pmean`` over ``'data'``, replacing Horovod's
allreduce) and its model axis row-shards the embedding tables. The port
runs one process per GPU, so the data axis is the process group: its size
is the world size, and every tensor is replicated on every rank. A 1x1
mesh is "no mesh", as ``build_mesh`` returns ``MeshInfo(None)`` there.
The model axis (``--mesh_model > 1``) and the partition specs that place
tensors on it are not ported yet (ROADMAP queue 1 item 4).

Hierarchical reduction: on a multi-host layout the flat all_reduce mixes
fast intra-host links with the slower fabric between hosts;
:func:`hierarchical_psum` reduces within each host first, then across one
member per host (``new_group``s built from :func:`data_axis_host_groups`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import Config
from . import bootstrap

# (intra-host, inter-host) rank groups of a two-stage 'data' reduce.
HierGroups = Tuple[List[List[int]], List[List[int]]]


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """The data axis: ``data_size`` ranks, one GPU each; ``model_size`` is
    1 (a model axis is not ported)."""
    data_size: int = 1
    model_size: int = 1

    @property
    def is_mesh(self) -> bool:
        return self.data_size * self.model_size > 1


def build_mesh(cfg: Config, world: Optional[int] = None) -> MeshInfo:
    """The data axis of ``cfg``: ``mesh_data`` 0 means every process, any
    other value must equal the number of processes (one GPU each)."""
    if cfg.mesh_model > 1:
        raise NotImplementedError(
            f"--mesh_model {cfg.mesh_model} (embedding rows sharded over a "
            "model axis) is not yet ported to deepfm_tpu_torch (ROADMAP "
            "queue 1 item 4)")
    world = bootstrap.process_count() if world is None else world
    data = cfg.mesh_data if cfg.mesh_data > 0 else world
    if data != world:
        raise ValueError(
            f"--mesh_data {cfg.mesh_data} must be 0 or the number of "
            f"processes ({world}): the port runs one process per GPU")
    return MeshInfo(data_size=data)


def local_batch_size(cfg: Config, world: int) -> int:
    """Each of ``world`` ranks' rows of the global ``batch_size``."""
    if cfg.batch_size % max(world, 1) != 0:
        raise ValueError(
            f"global batch_size={cfg.batch_size} not divisible by "
            f"process_count={world}")
    return cfg.batch_size // max(world, 1)


# ---------------------------------------------------------------------------
# Hierarchical (host-aware) reduction
# ---------------------------------------------------------------------------


def host_groups_from_hosts(row_host: Sequence[str]) -> Optional[HierGroups]:
    """(intra-host, inter-host) rank groups from each rank's host, or None
    when the layout does not decompose: one host, one rank per host, or a
    host owning a non-contiguous or unequal run of ranks (the JAX
    package's rule over its data-axis rows)."""
    D = len(row_host)
    hosts = sorted(set(row_host))
    if len(hosts) < 2 or len(hosts) >= D:
        return None
    per_host = D // len(hosts)
    if per_host * len(hosts) != D:
        return None
    intra: List[List[int]] = []
    for h_start in range(0, D, per_host):
        block = row_host[h_start:h_start + per_host]
        if len(set(block)) != 1:
            return None
        intra.append(list(range(h_start, h_start + per_host)))
    if len({row_host[g[0]] for g in intra}) != len(intra):
        return None
    inter = [[g[k] for g in intra] for k in range(per_host)]
    return intra, inter


def data_axis_host_groups(info: MeshInfo) -> Optional[HierGroups]:
    """The host layout of the data axis: each rank's host name, gathered
    once, through :func:`host_groups_from_hosts`."""
    if not info.is_mesh:
        return None
    import socket  # noqa: PLC0415
    return host_groups_from_hosts(
        bootstrap.allgather_objects(socket.gethostname()))


def _my_groups(groups: HierGroups) -> Tuple[object, object]:
    """This rank's (intra-host, inter-host) process groups; every rank
    creates every group of both stages, in order."""
    rank = bootstrap.process_index()
    mine = []
    for stage in groups:
        found = None
        for ranks in stage:
            pg = bootstrap.subgroup(ranks)
            if rank in ranks:
                found = pg
        if found is None:
            raise ValueError(f"rank {rank} is in no group of {stage}")
        mine.append(found)
    return mine[0], mine[1]


def hierarchical_psum(tensors: Iterable[torch.Tensor],
                      groups: HierGroups) -> List[torch.Tensor]:
    """Two-stage sum over the data ranks, in place: within each host, then
    across hosts. It adds the same terms as a flat all_reduce in another
    association: equal within 1-2 ulp, never bit-guaranteed."""
    intra, inter = _my_groups(groups)
    out = list(tensors)
    for t in out:
        dist.all_reduce(t, group=intra)
    for t in out:
        dist.all_reduce(t, group=inter)
    return out


def hierarchical_pmean(tensors: Iterable[torch.Tensor], groups: HierGroups,
                       axis_size: int) -> List[torch.Tensor]:
    """pmean as :func:`hierarchical_psum` times ``1 / axis_size``."""
    out = hierarchical_psum(tensors, groups)
    inv = 1.0 / float(axis_size)
    for t in out:
        t.mul_(inv)
    return out


def grad_payload_bytes(params: Dict[str, torch.Tensor],
                       embedding_keys: Iterable[str], model_size: int = 1,
                       *, embedding_shard: str = "off") -> int:
    """Bytes of ONE gradient all_reduce over the data ranks (the payload; a
    ring moves about twice it): every param is replicated and reduced in
    full. ``embedding_keys`` name the tables (their share would be
    1/model_size under a model axis, which is not ported). The
    ``embedding_shard rows`` leg (owner-local table space plus a touched
    mask) comes with that axis (ROADMAP queue 1 item 4)."""
    if embedding_shard == "rows":
        raise NotImplementedError(
            "--embedding_shard rows is not yet ported to deepfm_tpu_torch "
            "(ROADMAP queue 1 item 4)")
    emb = set(embedding_keys)
    total = 0
    for name, p in params.items():
        nbytes = p.numel() * p.element_size()
        if name in emb and model_size > 1:
            nbytes //= model_size
        total += nbytes
    return int(total)
