"""Elastic fits over a mesh of ranks that survive losing host groups.

The port's copy of `sml_tpu/ct/_elastic.py`. A fit on preemptible
capacity loses whole HOST GROUPS, not single rounds: the mesh shrinks,
the per-host row partition (`parallel.mesh.host_partition`) no longer
matches, and everything staged on the dead group's ranks is gone.
`elastic_fit` makes that an inconvenience instead of a restart from
zero:

- the fit runs as a `checkpointed_fit` on a host mesh of ranks
  (`parallel.mesh.host_mesh`), so every segment boundary has a durable
  round-level checkpoint (`BoostCheckpoint`, written by the mesh's
  lowest rank);
- a `HostPreempted` raised at a checkpoint boundary (a preemption
  notice, or the chaos hook's simulated kill) on any rank reaches every
  rank: each boundary all-reduces (MAX) one 8-byte flag carrying the
  dead group's index, so no rank is left inside the next collective;
- the survivors rebuild the host mesh over their groups (groups made by
  their members alone, `use_local_synchronization`, so ranks that left
  take no part), each re-ingests its new `host_view` of the rows, and
  the SAME `checkpointed_fit` call resumes from the newest checkpoint;
  the dead group's ranks leave by raising `HostPreempted`, since a dead
  host returns no model;
- every resume is visible: `elastic.resume` / `elastic.repartition`
  counters plus an `elastic.resume` event carrying the old and new
  group counts and the rows whose host assignment moved.

The draws are layout-invariant and the histograms are all-reduced in
float64 and rounded once, so the resumed model is the uninterrupted
fit's bit for bit, whatever the surviving mesh.

A rank that dies without a notice at a boundary leaves the others in a
collective until the group's timeout fires, and the fit fails; resuming
from that needs a restart of the ranks (torchrun's elastic launch).

Gate: `sml.ct.elasticResume` (off: `HostPreempted` propagates on every
rank); restart budget: `sml.ct.elasticMaxRestarts`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..conf import GLOBAL_CONF
from ..obs._recorder import RECORDER as _OBS
from ..parallel import collectives as coll
from ..parallel import mesh as meshlib
from ._checkpoint import checkpointed_fit


class HostPreempted(RuntimeError):
    """One host group died mid-fit. `group` is the dead group's index in
    the CURRENT mesh (None when unknown -- still triggers a resume, the
    last group is taken for the dead one)."""

    def __init__(self, msg: str = "host group preempted",
                 group: Optional[int] = None):
        super().__init__(msg)
        self.group = group


def moved_rows(n_rows: int, old_hosts: int, new_hosts: int) -> int:
    """Rows whose host-group assignment changes when the contiguous
    `host_partition` re-splits from `old_hosts` to `new_hosts` groups --
    the re-ingest traffic a resume pays (group g keeps the overlap of
    its old and new range; everything else moves)."""
    old = meshlib.host_partition(n_rows, old_hosts)
    new = meshlib.host_partition(n_rows, new_hosts)
    kept = 0
    for g in range(min(len(old), len(new))):
        (a0, a1), (b0, b1) = old[g], new[g]
        kept += max(0, min(a1, b1) - max(a0, b0))
    return max(0, int(n_rows)) - kept


def _surviving_mesh(mesh, dead_group: Optional[int]):
    """The host mesh over the groups that outlive a preemption: the same
    ranks a group, the dead group dropped (the LAST group when the
    notice named none); None on a rank of the dead group. Raises when no
    group survives."""
    groups = mesh.hosts
    per = mesh.size // groups
    if groups <= 1:
        raise HostPreempted("last host group preempted -- nothing to "
                            "resume on", group=dead_group)
    dead = groups - 1 if dead_group is None else int(dead_group) % groups
    if dead * per <= mesh.rank < (dead + 1) * per:
        return None
    survivors = mesh.ranks[:dead * per] + mesh.ranks[(dead + 1) * per:]
    base = meshlib.mesh_over(survivors, mesh)
    return meshlib.host_mesh(groups - 1, mesh=base)


def _boundary(mesh, on_checkpoint):
    """The checkpoint hook of an elastic fit on `mesh`: run the caller's
    `on_checkpoint`, then one MAX all-reduce of an int64 flag (0, or 1 +
    the dead group's index when the hook raised `HostPreempted` on this
    rank), and raise `HostPreempted` on every rank when any rank saw
    one."""
    groups = mesh.hosts

    def hook(t_done: int) -> None:
        seen = 0
        try:
            if on_checkpoint is not None:
                on_checkpoint(t_done)
        except HostPreempted as e:
            seen = 1 + (groups - 1 if e.group is None
                        else int(e.group) % groups)
        flag = int(coll.pmax(torch.tensor([seen], dtype=torch.int64,
                                          device=mesh.device),
                             mesh=mesh)[0])
        if flag:
            raise HostPreempted(f"host group {flag - 1} preempted after "
                                f"round {t_done}", group=flag - 1)
    return hook


def elastic_fit(source, checkpoint_dir: str, *, hosts: Optional[int] = None,
                devices_per_host: Optional[int] = None,
                on_checkpoint=None, **fit_params):
    """A `checkpointed_fit` on a host mesh of the ranks of the default
    process group (`hosts` groups, `devices_per_host` ranks each; every
    rank calls it) that survives losing host groups: on `HostPreempted`
    (raised by a preemption notice or the `on_checkpoint` chaos hook at
    a checkpoint boundary, on any rank) the mesh rebuilds over the
    survivors, each re-ingests its rows, and the fit resumes from the
    newest checkpoint. Returns the finished `_EnsembleSpec` on every
    surviving rank, exactly like `checkpointed_fit`; all its keyword
    parameters pass through. A rank of the dead group raises
    `HostPreempted`.

    `on_checkpoint(t_done)` fires after each checkpoint commits -- tests
    raise `HostPreempted` from it to kill a group at a known round
    boundary. With `sml.ct.elasticResume` off, or past
    `sml.ct.elasticMaxRestarts` resumes, the preemption propagates."""
    mesh = meshlib.host_mesh(hosts)
    if devices_per_host is not None \
            and int(devices_per_host) != mesh.size // mesh.hosts:
        raise ValueError(f"{mesh.hosts} host groups of {devices_per_host} "
                         f"ranks do not make the {mesh.size}-rank mesh")
    max_restarts = int(GLOBAL_CONF.get("sml.ct.elasticMaxRestarts") or 0)
    restarts = 0
    while True:
        try:
            with meshlib.use_mesh(mesh):
                return checkpointed_fit(
                    source, checkpoint_dir,
                    on_checkpoint=_boundary(mesh, on_checkpoint),
                    **fit_params)
        except HostPreempted as e:
            if (not GLOBAL_CONF.getBool("sml.ct.elasticResume")
                    or restarts >= max_restarts):
                raise
            restarts += 1
            old_groups = mesh.hosts
            survivor = _surviving_mesh(mesh, e.group)
            if survivor is None:
                raise
            mesh = survivor
            new_groups = mesh.hosts
            n_rows = getattr(source, "n_rows", None)
            moved = (moved_rows(n_rows, old_groups, new_groups)
                     if n_rows else None)
            if _OBS.enabled:
                _OBS.counter("elastic.resume")
                _OBS.counter("elastic.repartition")
                _OBS.emit("elastic", "elastic.resume", args={
                    "from_hosts": old_groups, "to_hosts": new_groups,
                    "dead_group": e.group, "moved_rows": moved,
                    "restart": restarts})
