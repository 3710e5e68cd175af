"""The mesh of `torch.distributed` ranks every data-parallel fit rides.

The port's counterpart of `sml_tpu/parallel/mesh.py`. The JAX package
drives a mesh of chips from one process and shards rows over its "data"
axis; PyTorch's idiom is one process (a rank) a device, so here a mesh
is a set of ranks of an initialized process group, each rank with its
own device and its own contiguous block of rows:

- `get_mesh()`: the calling thread's mesh (`use_mesh_local`), else the
  process-wide one (`set_mesh`, `use_mesh`), else, once a default
  process group is initialized, a flat mesh over all of its ranks.
  Without an initialized group there is no mesh (None), and a fit runs
  exactly as on one device, with no collective. An initialized group of
  any size, 1 included, is a mesh.
- `build_mesh(width)`: a flat mesh over the first `width` ranks.
- `host_mesh(hosts)`: the same ranks in host groups, the ("dcn", "ici")
  topology of a two-level allreduce. "ici" is the ranks of one group
  (one node, or one of `sml.mesh.hostGroups` virtual groups of
  contiguous ranks), "dcn" the ranks at the same position in each
  group.
- Rows: `host_partition` is the JAX package's split, the remainder to
  the leading blocks (`np.array_split`'s); `row_range` and `shard_rows`
  give a rank its block. No row is padded: in eager PyTorch nothing
  compiles per shape.

`new_group` is collective over the default group: every rank must call
`build_mesh` and `host_mesh` with the same arguments, in the same order.
A rank outside `build_mesh(width)`'s ranks gets None.

Each rank's device is the one `bind_rank_device` (or
`collectives.initialize_multihost`) bound, else `cuda:LOCAL_RANK`; the
port's `resolve_device(None)` answers it under a mesh. Not ported (ROADMAP
item 10): `submeshes`, `trial_mesh`, `run_placed_trials` over ranks,
`addressable_row_blocks` and `host_row_blocks`, and the JAX sharding
helpers (`data_sharding`, `replicated`, `pad_rows`, `row_mask`,
`bucket_rows`; the last is `dispatch.bucket_rows`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"    # row parallelism: ranks of a flat mesh
DCN_AXIS = "dcn"      # inter-host hop of a hierarchical (host-grouped) mesh
ICI_AXIS = "ici"      # intra-host hop of a hierarchical (host-grouped) mesh

_lock = threading.RLock()
_active_mesh: Optional["Mesh"] = None
_tls = threading.local()
_rank_device: Optional[torch.device] = None
#: the flat mesh over the default group, with the group it was built on
_default: list = [None, None]
#: memoized meshes: new_group is collective, so a repeated call must find
#: the groups every rank made, not make new ones on some ranks only
_built: Dict[tuple, "Mesh"] = {}


class Mesh:
    """Ranks of a process group as one mesh: `group` (the ranks' process
    group), `ranks` (their global ranks, in mesh order), this process's
    `rank` in it and its `device`. A host mesh (`host_mesh`) also holds
    this rank's two hops: `ici_group` (its host group's ranks) and
    `dcn_group` (the ranks at its position in every host group), and
    `hosts` groups of `size // hosts` ranks."""

    def __init__(self, group, ranks: Sequence[int], device: torch.device,
                 hosts: Optional[int] = None, ici_group=None,
                 dcn_group=None):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        self.hosts = hosts
        self.ici_group = ici_group
        self.dcn_group = dcn_group

    @property
    def hierarchical(self) -> bool:
        return self.hosts is not None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as the JAX package's `mesh.shape`."""
        if self.hierarchical:
            return {DCN_AXIS: self.hosts, ICI_AXIS: self.size // self.hosts}
        return {DATA_AXIS: self.size}

    def __repr__(self) -> str:
        return (f"Mesh(ranks={self.ranks}, rank={self.rank}, "
                f"shape={self.shape}, device={self.device}, "
                f"backend={self.backend})")


def bind_rank_device(device) -> None:
    """Bind this process's device: every mesh built after it puts this
    rank's work there (`initialize_multihost` binds its own)."""
    global _rank_device
    _rank_device = None if device is None else torch.device(device)


def rank_device() -> torch.device:
    """This rank's device: the bound one (`bind_rank_device`), else
    `cuda:LOCAL_RANK` (torchrun's variable; 0 without it)."""
    if _rank_device is not None:
        return _rank_device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world_mesh() -> Optional[Mesh]:
    """The flat mesh over the default group (built once per group)."""
    if not _initialized():
        return None
    world = dist.group.WORLD
    with _lock:
        if _default[0] is not world:
            _default[:] = [world, Mesh(world, range(dist.get_world_size()),
                                       rank_device())]
        return _default[1]


def build_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """A flat mesh over the first `n_devices` ranks of the default group
    (all of them by default). Every rank must call it; a rank outside
    the mesh gets None."""
    if not _initialized():
        raise RuntimeError("build_mesh needs an initialized default process "
                           "group (collectives.initialize_multihost)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n == world:
        return _world_mesh()
    key = ("flat", id(dist.group.WORLD), n)
    with _lock:
        if key not in _built:
            group = dist.new_group(ranks=list(range(n)))
            _built[key] = None if dist.get_rank() >= n \
                else Mesh(group, range(n), rank_device())
        return _built[key]


def get_mesh() -> Optional[Mesh]:
    """The active mesh: the calling thread's override, else the
    process-wide mesh, else the flat mesh over the initialized default
    group; None without one."""
    local = getattr(_tls, "mesh", None)
    if local is not None:
        return local
    with _lock:
        if _active_mesh is not None:
            return _active_mesh
    return _world_mesh()


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    with _lock:
        _active_mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Temporarily swap the process-wide mesh."""
    global _active_mesh
    with _lock:
        prev = _active_mesh
        _active_mesh = mesh
    try:
        yield mesh
    finally:
        with _lock:
            _active_mesh = prev


@contextlib.contextmanager
def use_mesh_local(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Bind a mesh to the CURRENT THREAD only."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def _node_count(size: int) -> int:
    """The nodes torchrun started the ranks on (WORLD_SIZE /
    LOCAL_WORLD_SIZE), 1 without its variables."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local <= 0 or size % local:
        return 1
    return size // local


def host_mesh(hosts: Optional[int] = None,
              mesh: Optional[Mesh] = None) -> Mesh:
    """The ranks of `mesh` (the flat mesh over the default group by
    default) in `hosts` host groups of contiguous ranks: group g is
    ranks [g*per, (g+1)*per), and rank r's two hops are its group
    ("ici") and the ranks at its position r % per in every group
    ("dcn"). `hosts` defaults to `sml.mesh.hostGroups`, else the node
    count (`_node_count`), clamped to [1, ranks]. The row blocks stay
    the flat mesh's, rank for rank. Every rank of `mesh` must call it
    with the same arguments; memoized per (ranks, hosts)."""
    base = mesh if mesh is not None else _world_mesh()
    if base is None:
        raise RuntimeError("host_mesh needs an initialized default process "
                           "group (collectives.initialize_multihost)")
    n = base.size
    if hosts is None or hosts <= 0:
        from ..conf import GLOBAL_CONF
        hosts = int(GLOBAL_CONF.get("sml.mesh.hostGroups") or 0)
    if hosts <= 0:
        hosts = _node_count(n)
    hosts = max(1, min(int(hosts), n))
    if n % hosts:
        raise ValueError(f"{hosts} host groups do not divide the {n}-rank "
                         f"mesh")
    per = n // hosts
    key = ("host", id(base.group), base.ranks, hosts)
    with _lock:
        hit = _built.get(key)
        if hit is not None:
            return hit
        ici = dcn = None
        me = base.ranks[base.rank]
        for g in range(hosts):
            ranks = list(base.ranks[g * per:(g + 1) * per])
            group = dist.new_group(ranks=ranks)
            if me in ranks:
                ici = group
        for i in range(per):
            ranks = list(base.ranks[i::per])
            group = dist.new_group(ranks=ranks)
            if me in ranks:
                dcn = group
        out = Mesh(base.group, base.ranks, base.device, hosts=hosts,
                   ici_group=ici, dcn_group=dcn)
        _built[key] = out
        return out


def is_hierarchical(mesh: Optional[Mesh] = None) -> bool:
    """True when the mesh declares the two-hop host topology — the signal
    `sml.tree.hierarchicalAllreduce=auto` keys on."""
    mesh = mesh or get_mesh()
    return mesh is not None and mesh.hierarchical


def row_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The axes rows shard over: ("dcn", "ici") on a host mesh, ("data",)
    everywhere else."""
    if is_hierarchical(mesh):
        return (DCN_AXIS, ICI_AXIS)
    return (DATA_AXIS,)


def data_width(mesh: Optional[Mesh] = None) -> int:
    """Number of row blocks: the mesh's ranks (1 without a mesh)."""
    mesh = mesh or get_mesh()
    return 1 if mesh is None else mesh.size


mesh_device_count = data_width


def host_group_of(mesh: Optional[Mesh] = None) -> dict:
    """Global rank -> host-group index (the mesh's "dcn" row); a flat
    mesh maps every rank to group 0."""
    mesh = mesh or get_mesh()
    if not is_hierarchical(mesh):
        return {r: 0 for r in mesh.ranks}
    per = mesh.size // mesh.hosts
    return {r: i // per for i, r in enumerate(mesh.ranks)}


def host_partition(n_rows: int, hosts: int) -> list:
    """Contiguous [start, stop) global row ranges, one per host group (or
    rank), the remainder rows to the leading ones (matching
    np.array_split)."""
    hosts = max(1, int(hosts))
    n = max(0, int(n_rows))
    per, extra = divmod(n, hosts)
    out, start = [], 0
    for g in range(hosts):
        stop = start + per + (1 if g < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def row_range(n_rows: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """This rank's [start, stop) of `n_rows` global rows: block `rank`
    of `host_partition(n_rows, size)`, on a host mesh as on the flat
    one."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return 0, int(n_rows)
    return host_partition(n_rows, mesh.size)[mesh.rank]


def shard_rows(x: np.ndarray, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's block of the rows of `x` (a view)."""
    start, stop = row_range(len(x), mesh)
    return x[start:stop]
