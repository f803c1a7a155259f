"""Data parallelism over ``torch.distributed``: the bootstrap and the data
axis (port of ``deepfm_tpu.parallel``)."""

from . import bootstrap, mesh  # noqa: F401
from .mesh import MeshInfo, build_mesh  # noqa: F401
