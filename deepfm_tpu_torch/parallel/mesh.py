"""The ``('data', 'model')`` mesh over ``torch.distributed`` (port of
``deepfm_tpu.parallel.mesh``).

The JAX package lays a ``('data', 'model')`` device mesh: its data axis
averages the gradients (``pmean`` over ``'data'``, replacing Horovod's
allreduce) and its model axis row-shards the embedding tables (replacing
the parameter server's hosted tables). The port runs one process per GPU,
``D * M`` processes for ``--mesh_data D --mesh_model M``; rank r sits at
``(r // M, r % M)``, as the JAX package reshapes its devices ``[data,
model]``, so model peers are adjacent ranks. The data group of a rank is
its mesh column (the ranks of its model index: they hold the same shard
and average their gradients), its model group its mesh row (the ranks of
its data index: they read the same batch and hold the table between
them). A 1x1 mesh is "no mesh", as ``build_mesh`` returns
``MeshInfo(None)`` there.

Placement (``param_pspecs``, ``opt_state_pspecs``, ``batch_pspecs``): the
embedding tables and their optimizer slots are row-sharded over the model
axis when it is real (size > 1); everything else is replicated, and every
batch column is sharded over the data axis.

Hierarchical reduction: on a multi-host layout the flat all_reduce mixes
fast intra-host links with the slower fabric between hosts;
:func:`hierarchical_psum` reduces within each host first, then across one
member per host (``new_group``s built from :func:`data_axis_host_groups`),
on a data-only mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import Config
from ..ops import embedding as emb_ops
from . import bootstrap

DATA_AXIS = "data"
MODEL_AXIS = "model"

# (intra-host, inter-host) rank groups of a two-stage 'data' reduce.
HierGroups = Tuple[List[List[int]], List[List[int]]]


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """The mesh: ``data_size`` x ``model_size`` ranks, one GPU each, and
    this rank's coordinates on it."""
    data_size: int = 1
    model_size: int = 1
    data_index: int = 0
    model_index: int = 0

    @property
    def is_mesh(self) -> bool:
        return self.data_size * self.model_size > 1

    @property
    def num_processes(self) -> int:
        return self.data_size * self.model_size

    def data_ranks(self, model_index: Optional[int] = None) -> List[int]:
        """The ranks of one mesh column (default: this rank's)."""
        j = self.model_index if model_index is None else model_index
        return [d * self.model_size + j for d in range(self.data_size)]

    def model_ranks(self, data_index: Optional[int] = None) -> List[int]:
        """The ranks of one mesh row (default: this rank's)."""
        d = self.data_index if data_index is None else data_index
        return [d * self.model_size + j for j in range(self.model_size)]

    def data_group(self) -> Any:
        """The process group of this rank's data peers: None (the default
        group) when the data axis spans every rank, or in one process."""
        if self.model_size == 1 or self.data_size == 1 \
                or not dist.is_initialized():
            return None
        return bootstrap.subgroup(self.data_ranks())

    def model_group(self) -> Any:
        """The process group of this rank's model peers: None (the default
        group) when the model axis spans every rank, or in one process."""
        if self.data_size == 1 or self.model_size == 1 \
                or not dist.is_initialized():
            return None
        return bootstrap.subgroup(self.model_ranks())

    def model_axis(self) -> Optional[emb_ops.ModelAxis]:
        """This rank's :class:`ops.embedding.ModelAxis`; None without a
        model axis."""
        if self.model_size <= 1:
            return None
        return emb_ops.ModelAxis(self.model_index, self.model_size,
                                 self.model_group())


def mesh_shape(cfg: Config, world: int) -> Tuple[int, int]:
    """(D, M) of ``cfg`` over ``world`` processes: ``mesh_model`` M and
    ``mesh_data`` D (0: every process the model axis leaves, world / M),
    D * M equal to ``world`` (one GPU each); else ``ValueError`` naming the
    flags."""
    model = max(int(cfg.mesh_model), 1)
    if world % model:
        raise ValueError(
            f"--mesh_model {model} does not divide the number of processes "
            f"({world}): the port runs one process per GPU")
    data = cfg.mesh_data if cfg.mesh_data > 0 else world // model
    if data * model != world:
        raise ValueError(
            f"--mesh_data {cfg.mesh_data} x --mesh_model {model} must equal "
            f"the number of processes ({world}): the port runs one process "
            "per GPU (--mesh_data 0 takes every process the model axis "
            "leaves)")
    return data, model


def build_mesh(cfg: Config, world: Optional[int] = None) -> MeshInfo:
    """The mesh of ``cfg`` over the processes (:func:`mesh_shape`) and this
    rank's coordinates. Under a 2-D mesh every rank creates every data
    group, then every model group, in one order (``new_group`` is
    collective)."""
    world = bootstrap.process_count() if world is None else world
    data, model = mesh_shape(cfg, world)
    rank = bootstrap.process_index() if world > 1 else 0
    info = MeshInfo(data_size=data, model_size=model,
                    data_index=rank // model, model_index=rank % model)
    if data > 1 and model > 1 and dist.is_initialized():
        for j in range(model):
            bootstrap.subgroup(info.data_ranks(j))
        for d in range(data):
            bootstrap.subgroup(info.model_ranks(d))
    return info


# ---------------------------------------------------------------------------
# Placement (the JAX partition specs)
# ---------------------------------------------------------------------------


def param_pspecs(params: Dict[str, Any], embedding_keys: Iterable[str],
                 model_size: int = 1) -> Dict[str, Optional[str]]:
    """Per flat param name, the mesh axis its dim 0 is split over:
    ``"model"`` for an embedding table when the model axis is real, else
    None (replicated)."""
    emb = set(embedding_keys)
    return {k: (MODEL_AXIS if model_size > 1 and k in emb else None)
            for k in params}


def batch_pspecs(batch: Dict[str, Any]) -> Dict[str, str]:
    """Every batch column is split over the data axis on dim 0."""
    return {k: DATA_AXIS for k in batch}


def _is_record(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def opt_state_pspecs(opt_state: Any, param_specs: Dict[str, Optional[str]],
                     embed_names: Iterable[str] = ()) -> Any:
    """The optimizer state's specs, tree for tree: a slot keyed by a param
    (``mu[<param>]``) takes that param's spec; the sparse update's lazy-Adam
    slots (``embed[<name>][<table>]``: m, v and tau) take the model axis
    with their table; counts and the base optimizer's other slots are
    replicated."""
    sharded = {k for k, s in param_specs.items() if s == MODEL_AXIS}
    names = set(embed_names)

    def walk(tree, path):
        if _is_record(tree):
            return type(tree)(**{k: walk(v, path + (k,))
                                 for k, v in tree._asdict().items()})
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return None
        rows = (set(path) & sharded) or (
            sharded and len(path) > 1 and path[0] == "embed"
            and path[1] in names)
        return MODEL_AXIS if rows else None

    return walk(opt_state, ())


def local_batch_size(cfg: Config, world: int) -> int:
    """Each of ``world`` data ranks' rows of the global ``batch_size``."""
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
    once, through :func:`host_groups_from_hosts`. Only on a data-only mesh
    (the two-stage reduce is not composed with the model axis)."""
    if not info.is_mesh or info.model_size > 1:
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
    ring moves about twice it), the JAX package's accounting.

    Dense update: the tables row-sharded over the model axis reduce their
    1/model_size slice; everything else is replicated and reduced in full.
    ``embedding_shard rows``: each owner reduces its table-space slice
    (the whole table when model_size is 1, NOT divided) plus one
    touched-union mask [rows_local] of 4 bytes per physical table, counted
    against the tables of the first embedding param (the first key's
    ``<param>`` before any ``.<table>``)."""
    keys = list(embedding_keys)
    emb = set(keys)
    first = keys[0].split(".")[0] if keys else None
    shards = max(model_size, 1)
    total = 0
    for name, p in params.items():
        nbytes = p.numel() * p.element_size()
        if name in emb:
            if embedding_shard == "rows":
                nbytes //= shards
                if name.split(".")[0] == first:
                    nbytes += (int(p.shape[0]) // shards) * 4
            elif shards > 1:
                nbytes //= shards
        total += nbytes
    return int(total)
