"""The port's parallel layer: the mesh of ranks and its collectives
(`mesh.py`, `collectives.py`), the dispatcher (`dispatch.py`), host-side
pipelining (`pipeline.py`) and prewarm (`prewarm.py`)."""

from . import collectives, mesh
from .mesh import (DATA_AXIS, DCN_AXIS, ICI_AXIS, Mesh, build_mesh,
                   get_mesh, host_mesh, host_partition, mesh_device_count,
                   row_range, set_mesh, shard_rows, use_mesh, use_mesh_local)

__all__ = [
    "collectives", "mesh", "DATA_AXIS", "DCN_AXIS", "ICI_AXIS", "Mesh",
    "build_mesh", "get_mesh", "host_mesh", "host_partition",
    "mesh_device_count", "row_range", "set_mesh", "shard_rows", "use_mesh",
    "use_mesh_local",
]
