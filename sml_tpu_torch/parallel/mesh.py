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
- `trial_mesh(t)`: the same ranks as t lanes of contiguous ranks, the
  JAX package's ("trial", "data") mesh. A rank's mesh is its lane: its
  "data" group is the lane's ranks, its "trial" group the ranks at its
  position in every lane. Fused tuning fits spread their elements over
  the lanes (`tree_impl.fit_ensembles_trials`).
- `submeshes(k)`: min(k, ranks) disjoint groups of contiguous ranks,
  cycled to k; `run_placed_trials` runs tuning's trials on them, each
  group its own trials, data-parallel inside the group, and records
  each trial's ranks in `PLACEMENT_LOG`.
- Rows: `host_partition` is the JAX package's split, the remainder to
  the leading blocks (`np.array_split`'s); `row_range` and `shard_rows`
  give a rank its block, and `addressable_row_blocks` /
  `host_row_blocks` the (device, block) view a skew probe walks: a rank
  addresses its own block only. No row is padded: in eager PyTorch
  nothing compiles per shape.

`new_group` is collective: every rank of a mesh must call `build_mesh`,
`host_mesh`, `trial_mesh` and `submeshes` with the same arguments, in the
same order. Each group is made once (`_group`, memoized by its ranks),
by every rank of the default group when the mesh spans it, else by the
group's own members (`use_local_synchronization`). A rank outside
`build_mesh(width)`'s ranks gets None; a submesh this rank is not in has
`rank` None.

Each rank's device is the one `bind_rank_device` (or
`collectives.initialize_multihost`) bound, else `cuda:LOCAL_RANK`; the
port's `resolve_device(None)` answers it under a mesh. Left out on
purpose: the JAX sharding helpers (`data_sharding`, `replicated`,
`pad_rows`, `row_mask`; a rank holds its block unpadded) and
`bucket_rows` (it is `dispatch.bucket_rows`).
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
TRIAL_AXIS = "trial"  # fused trial elements over lanes (trial_mesh)

_lock = threading.RLock()
_active_mesh: Optional["Mesh"] = None
_tls = threading.local()
_rank_device: Optional[torch.device] = None
#: the flat mesh over the default group, with the group it was built on
_default: list = [None, None]
#: memoized meshes: new_group is collective, so a repeated call must find
#: the groups every rank made, not make new ones on some ranks only
_built: Dict[tuple, object] = {}
#: memoized process groups by (default group, ranks) (`_group`)
_groups: Dict[tuple, object] = {}


class Mesh:
    """Ranks of a process group as one mesh: `group` (the ranks' process
    group), `ranks` (their global ranks, in mesh order), this process's
    `rank` in it (None for a submesh this process is not in) and its
    `device`. A host mesh (`host_mesh`) also holds this rank's two hops:
    `ici_group` (its host group's ranks) and `dcn_group` (the ranks at
    its position in every host group), and `hosts` groups of
    `size // hosts` ranks. A lane of a trial mesh (`trial_mesh`) holds
    `trials` lanes, its index `lane` and `trial_group` (the ranks at its
    position in every lane); its `group` is the lane's ranks."""

    def __init__(self, group, ranks: Sequence[int], device: torch.device,
                 hosts: Optional[int] = None, ici_group=None,
                 dcn_group=None, trials: Optional[int] = None,
                 trial_group=None, lane: Optional[int] = None):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(
            group if group is not None else dist.group.WORLD))
        self.spans_world = self.size == dist.get_world_size()
        self.hosts = hosts
        self.ici_group = ici_group
        self.dcn_group = dcn_group
        self.trials = trials
        self.trial_group = trial_group
        self.lane = lane

    @property
    def hierarchical(self) -> bool:
        return self.hosts is not None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as the JAX package's `mesh.shape`."""
        if self.hierarchical:
            return {DCN_AXIS: self.hosts, ICI_AXIS: self.size // self.hosts}
        if self.trials is not None:
            return {TRIAL_AXIS: self.trials, DATA_AXIS: self.size}
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


def _group(ranks: Sequence[int], local: bool = False):
    """The process group of `ranks` (global ranks), made once per
    default group and memoized by its ranks: the default group itself
    when they are all of its ranks, else `dist.new_group`, which every
    rank of the default group must call in the same order, or with
    `local` only the members (`use_local_synchronization`; a non-member
    returns at once). A non-member gets None."""
    ranks = tuple(int(r) for r in ranks)
    world = dist.group.WORLD
    if ranks == tuple(range(dist.get_world_size())):
        return world
    key = (id(world), ranks)
    member = dist.get_rank() in ranks
    with _lock:
        if key not in _groups:
            group = None
            if member or not local:
                # torchlint: disable=divergent-collective -- with use_local_synchronization only the members make the group, so a non-member skips new_group on purpose; without it (local False) every rank calls
                group = dist.new_group(ranks=list(ranks),
                                       use_local_synchronization=local)
            _groups[key] = group if member else None
        return _groups[key]


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
            group = _group(range(n))
            _built[key] = None if dist.get_rank() >= n \
                else Mesh(group, range(n), rank_device())
        return _built[key]


def mesh_over(ranks: Sequence[int], parent: Mesh) -> Optional[Mesh]:
    """A flat mesh over `ranks`, global ranks of `parent`, on this
    rank's device, its group made by its members alone (`_group` with
    `local`: ranks outside it, which may have left, take no part); None
    on a rank outside them."""
    ranks = tuple(int(r) for r in ranks)
    if not set(ranks) <= set(parent.ranks):
        raise ValueError(f"ranks {ranks} are not all in {parent!r}")
    key = ("over", id(dist.group.WORLD), ranks)
    with _lock:
        if key not in _built:
            group = _group(ranks, local=True)
            _built[key] = None if group is None \
                else Mesh(group, ranks, parent.device)
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


def release() -> None:
    """Drop every mesh and process group this module holds (the flat
    mesh over the default group, the memoized meshes and groups, the
    process-wide mesh), so that a destroyed default group's objects are
    freed now rather than at interpreter teardown
    (`collectives.initialize_multihost`'s exit hook)."""
    global _active_mesh
    with _lock:
        _default[:] = [None, None]
        _built.clear()
        _groups.clear()
        _active_mesh = None


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
    with the same arguments; its groups are made by every rank of the
    default group, or, when `mesh` does not span the default group, by
    their members alone (`_group`); memoized per (ranks, hosts)."""
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
    local = not base.spans_world
    per = n // hosts
    key = ("host", id(base.group), base.ranks, hosts)
    with _lock:
        hit = _built.get(key)
        if hit is not None:
            return hit
        ici = dcn = None
        for g in range(hosts):
            group = _group(base.ranks[g * per:(g + 1) * per], local)
            if base.rank is not None and base.rank // per == g:
                ici = group
        for i in range(per):
            group = _group(base.ranks[i::per], local)
            if base.rank is not None and base.rank % per == i:
                dcn = group
        out = Mesh(base.group, base.ranks, base.device, hosts=hosts,
                   ici_group=ici, dcn_group=dcn)
        _built[key] = out
        return out


def trial_mesh(trial_dim: int, mesh: Optional[Mesh] = None) -> Mesh:
    """The ranks of `mesh` (the active mesh by default) as `trial_dim`
    lanes of `size // trial_dim` contiguous ranks, the JAX package's 2-D
    ("trial", "data") mesh: this rank's mesh is its lane (`group`, and
    the "data" axis of the collectives), with `trial_group` the ranks at
    its position in every lane (the "trial" axis). `trial_dim` must
    divide the rank count. Every rank of `mesh` must call it; memoized
    per (ranks, trial_dim)."""
    mesh = mesh or get_mesh()
    if mesh is None or mesh.rank is None:
        raise RuntimeError("trial_mesh needs a mesh this rank is in")
    n = mesh.size
    t = max(1, int(trial_dim))
    if n % t:
        raise ValueError(f"trial axis {t} does not divide the {n}-rank "
                         f"mesh")
    key = ("trial", id(mesh.group), mesh.ranks, t)
    with _lock:
        hit = _built.get(key)
        if hit is not None:
            return hit
        per = n // t
        local = not mesh.spans_world
        lanes = [_group(mesh.ranks[lane * per:(lane + 1) * per], local)
                 for lane in range(t)]
        trials = [_group(mesh.ranks[i::per], local) for i in range(per)]
        lane = mesh.rank // per
        out = Mesh(lanes[lane], mesh.ranks[lane * per:(lane + 1) * per],
                   mesh.device, trials=t, trial_group=trials[mesh.rank % per],
                   lane=lane)
        _built[key] = out
        return out


def submeshes(k: int, mesh: Optional[Mesh] = None) -> list:
    """The ranks of `mesh` (the active mesh by default) in min(k, ranks)
    disjoint groups of contiguous ranks, the leading groups one rank
    larger where they do not divide evenly, cycled to length k. A group
    spanning the whole (flat) parent is the parent. A submesh this rank
    is not in has `rank` None. Every rank of `mesh` must call it;
    memoized per (ranks, groups)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("submeshes needs a mesh (an initialized default "
                           "process group)")
    n = mesh.size
    k = max(1, int(k))
    groups = min(k, n)
    key = ("sub", id(mesh.group), mesh.ranks, groups)
    with _lock:
        if key not in _built:
            per, extra = divmod(n, groups)
            local = not mesh.spans_world
            out, start = [], 0
            for g in range(groups):
                size = per + (1 if g < extra else 0)
                ranks = mesh.ranks[start:start + size]
                if size == n and not mesh.hierarchical \
                        and mesh.trials is None:
                    out.append(mesh)
                else:
                    out.append(Mesh(_group(ranks, local), ranks,
                                    mesh.device))
                start += size
            _built[key] = out
        cached = _built[key]
    return [cached[i % groups] for i in range(k)]


#: (trial index, the ranks it ran on) of every placed trial
PLACEMENT_LOG: list = []
_PLACEMENT_LOG_MAX = 4096


def _log_placement(idx: int, mesh: Mesh) -> None:
    with _lock:
        if len(PLACEMENT_LOG) >= _PLACEMENT_LOG_MAX:
            del PLACEMENT_LOG[: _PLACEMENT_LOG_MAX // 2]
        PLACEMENT_LOG.append((int(idx), tuple(mesh.ranks)))


def run_placed_trials(jobs: Sequence, fn, parallelism: int,
                      mesh: Optional[Mesh] = None) -> list:
    """`fn(job)` for every job over the ranks of `mesh` (the active mesh
    by default), results in job order on every rank: the JAX package's
    placed trials, each on a disjoint submesh, with ranks in the place
    of its worker threads (`SML/ML 07:120-130`, `SML/Labs/ML
    08L:89-107`).

    With `parallelism` above 1 job i runs on submesh i % groups
    (`submeshes`; the JAX package hands jobs to whichever submesh's
    thread is free): each rank runs its group's jobs in job order, with
    the submesh bound to the thread (`use_mesh_local`), so a trial's
    fits are data-parallel inside its group. One `all_gather_object`
    over `mesh` carries each group's first rank's values and every
    rank's exceptions, so a trial that raises, on all of its group or
    on one rank of it, leaves no group waiting and counts as failed;
    every rank then raises the first failure in job order, else returns
    the values. With `parallelism` 1 every rank
    runs every job on the whole mesh. Every trial's ranks are recorded
    in `PLACEMENT_LOG`, on every rank. Every rank of `mesh` must call it
    with the same jobs."""
    import pickle

    from . import collectives as coll
    jobs = list(jobs)
    mesh = mesh or get_mesh()
    if mesh is None or mesh.rank is None:
        raise RuntimeError("run_placed_trials over ranks needs a mesh this "
                           "rank is in")
    parallelism = max(1, int(parallelism))
    if parallelism <= 1 or len(jobs) <= 1:
        out = []
        with use_mesh_local(mesh):
            for i, job in enumerate(jobs):
                _log_placement(i, mesh)
                out.append(fn(job))
        return out
    meshes = submeshes(parallelism, mesh)
    groups = min(parallelism, mesh.size)
    placed = [meshes[i % groups] for i in range(len(jobs))]
    for i, sub in enumerate(placed):
        _log_placement(i, sub)
    mine: dict = {}
    for i, (job, sub) in enumerate(zip(jobs, placed)):
        if sub.rank is None:
            continue
        with use_mesh_local(sub):
            try:
                mine[i] = (True, fn(job))
            except Exception as e:   # re-raised on every rank, below
                mine[i] = (False, e)
    lead = next(m for m in meshes[:groups] if m.rank is not None).rank == 0
    sent = {}
    for i, (ok, value) in mine.items():
        if not ok:
            try:
                pickle.dumps(value)
            except (pickle.PicklingError, TypeError, AttributeError):
                value = RuntimeError(f"trial {i} raised {value!r}")
            sent[i] = (False, value)
        elif lead:
            sent[i] = (True, value)
    merged: dict = {}
    for part in coll.all_gather_object(sent, mesh=mesh):
        for i, (ok, value) in part.items():
            if i not in merged or (merged[i][0] and not ok):
                merged[i] = (ok, value)
    for i, (ok, value) in mine.items():
        if ok == merged[i][0]:   # this rank's own, unpickled
            merged[i] = (ok, value)
    for i in range(len(jobs)):
        ok, value = merged[i]
        if not ok:
            raise value
    return [merged[i][1] for i in range(len(jobs))]


def is_hierarchical(mesh: Optional[Mesh] = None) -> bool:
    """True when the mesh declares the two-hop host topology — the signal
    `sml.tree.hierarchicalAllreduce=auto` keys on."""
    mesh = mesh or get_mesh()
    return mesh is not None and mesh.hierarchical


def row_axes(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """The axes rows shard over: ("dcn", "ici") on a host mesh, ("data",)
    everywhere else (on a lane of a trial mesh, the lane's ranks)."""
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


def addressable_row_blocks(arr, mesh: Optional[Mesh] = None) -> list:
    """The (device, block) pairs of the row blocks of `arr` (an array or
    tensor of all the rows, as every rank holds them) that this rank
    addresses, in row order: under a mesh its own block alone
    (`shard_rows`) on its device, the JAX package's per-chip view of a
    row-sharded array for the one chip a rank drives; without a mesh
    one pair of the whole array (its device for a tensor, else the
    CPU)."""
    mesh = mesh or get_mesh()
    if mesh is None or mesh.rank is None:
        dev = arr.device if isinstance(arr, torch.Tensor) \
            else torch.device("cpu")
        return [(dev, arr)]
    return [(mesh.device, shard_rows(arr, mesh))]


def host_row_blocks(arr, mesh: Optional[Mesh] = None) -> list:
    """Per-host-group view of `addressable_row_blocks`: one (group index,
    [(device, block), ...]) pair per host group this rank addresses
    blocks in (`host_group_of`; its own group alone under a mesh, group
    0 without one), the walk a multi-host skew probe makes."""
    mesh = mesh or get_mesh()
    blocks = addressable_row_blocks(arr, mesh)
    if mesh is None or mesh.rank is None:
        return [(0, blocks)]
    return [(host_group_of(mesh)[mesh.ranks[mesh.rank]], blocks)]
