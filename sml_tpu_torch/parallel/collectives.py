"""The collectives of a mesh of ranks, over `torch.distributed`.

The port's counterpart of `sml_tpu/parallel/collectives.py`: estimator
code never spells a raw `torch.distributed` call. Where the JAX package
runs a named collective inside a traced program over a mesh axis, the
port calls one on the process group of that axis (`mesh.py`): "data"
(or the ("dcn", "ici") pair) is the whole mesh (on a lane of a trial
mesh, the lane), "ici" this rank's host group, "dcn" the ranks at its
position in every group and "trial" the ranks at its position in every
lane. Each wrapper returns a new tensor and leaves its operand as it
was.

- `psum` / `pmax` / `pmin`: `all_reduce` (SUM / MAX / MIN); `pmean` the
  sum over the rank count; `psum_scalars` one `all_reduce` of a stacked
  float64 vector; `masked_count` the summed 0/1 mask.
- `all_gather` (`all_gather_single`, once `all_gather_into_tensor`;
  tiled or stacked), `reduce_scatter` (`reduce_scatter_single`, once
  `reduce_scatter_tensor`; tiled), `all_to_all`
  (`all_to_all_single`, tiled) and `ppermute` (`send` / `recv` pairs;
  a rank nothing is sent to gets zeros).
- `psum_hierarchical`: `reduce_scatter` on "ici", `all_reduce` of the
  chunk on "dcn", `all_gather` on "ici", the payload zero-padded to a
  multiple of the group size.
- `axis_index`: this rank's index on an axis.
- `all_gather_object`: every rank's picklable object, in rank order.
- `initialize_multihost`: `init_process_group` with the caller's backend,
  typed failures (`MultihostInitError`), under the watchdog, and an exit
  hook that waits for every rank and then takes the group down
  (`_shutdown`), as the JAX package's `jax.distributed` client waits for
  its peers when it terminates.

gloo reduces CUDA tensors natively only in `all_reduce` and `broadcast`
(PyTorch's backend table). Under gloo, `reduce_scatter`, `all_gather`,
`all_to_all` and `ppermute` therefore copy a CUDA payload to host
memory, run there and copy the result back, explicitly; under NCCL they
never do.

Every call counts, in `COUNTS` always and in the flight recorder's
counters when it is on, `collective.<op>` and its payload bytes
`collective.<op>_bytes` (one rank's operand: shape x itemsize), and a
hop of `psum_hierarchical` under `collective.<op>.<hop>` /
`collective.<op>_bytes.<hop>`. The JAX package notes each collective
once per traced program; the port counts each call.
"""

from __future__ import annotations

import atexit
import sys
import threading
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..obs import _context as _trace
from ..obs._recorder import RECORDER as _OBS
from ..obs._watchdog import WATCHDOG as _WATCHDOG
from . import mesh as _mesh
from .mesh import DATA_AXIS, DCN_AXIS, ICI_AXIS, TRIAL_AXIS

#: collective.<op>[.<hop>] calls and collective.<op>_bytes[.<hop>] payload
#: bytes of this process, counted whether the recorder is on or not
COUNTS: Dict[str, float] = {}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        COUNTS.clear()


def _payload_bytes(x: torch.Tensor) -> float:
    return float(x.numel() * x.element_size())


def _note(op: str, x: Optional[torch.Tensor] = None,
          hop: Optional[str] = None) -> None:
    """Count one collective call and its payload (`hop` keys a hop of a
    hierarchical one), and emit its event when the recorder is on."""
    sfx = "" if hop is None else "." + hop
    nbytes = None if x is None else _payload_bytes(x)
    with _count_lock:
        name = f"collective.{op}{sfx}"
        COUNTS[name] = COUNTS.get(name, 0.0) + 1.0
        if nbytes:
            name = f"collective.{op}_bytes{sfx}"
            COUNTS[name] = COUNTS.get(name, 0.0) + nbytes
    if _OBS.enabled:
        _OBS.emit("collective", f"collective.{op}{sfx}",
                  args=_trace.trace_args(
                      None if nbytes is None else {"bytes": nbytes}))
        _OBS.counter(f"collective.{op}{sfx}")
        if nbytes:
            _OBS.counter(f"collective.{op}_bytes{sfx}", nbytes)


def _resolve(axis, mesh) -> Tuple[object, int, int, str]:
    """(process group, ranks, this rank's index, backend) of `axis` on
    `mesh` (the active mesh by default). "data", and the ("dcn", "ici")
    pair, are the whole mesh; "ici" and "dcn" need a host mesh, "trial"
    a lane of a trial mesh."""
    mesh = mesh or _mesh.get_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: a collective needs an initialized "
                           "process group (initialize_multihost)")
    if isinstance(axis, (tuple, list)):
        if tuple(axis) not in ((DCN_AXIS, ICI_AXIS), (DATA_AXIS,)):
            raise ValueError(f"unknown axes {axis!r}")
        axis = DATA_AXIS
    if axis == DATA_AXIS:
        group = mesh.group
    elif axis in (ICI_AXIS, DCN_AXIS):
        if not mesh.hierarchical:
            raise ValueError(f"axis {axis!r} needs a host mesh "
                             f"(mesh.host_mesh)")
        group = mesh.ici_group if axis == ICI_AXIS else mesh.dcn_group
    elif axis == TRIAL_AXIS:
        if mesh.trials is None:
            raise ValueError(f"axis {axis!r} needs a trial mesh "
                             f"(mesh.trial_mesh)")
        group = mesh.trial_group
    else:
        raise ValueError(f"unknown axis {axis!r}")
    return (group, dist.get_world_size(group), dist.get_rank(group),
            mesh.backend)


def _dist(name: str, older: str):
    """`torch.distributed.<name>`, or its older spelling `<older>` (same
    arguments) in a torch that lacks it."""
    return getattr(dist, name, None) or getattr(dist, older)


def _staged(x: torch.Tensor, backend: str) -> bool:
    """Whether gloo must run this payload's collective on a host copy."""
    return x.is_cuda and backend == "gloo"


def _reduce(x: torch.Tensor, op, axis, mesh) -> torch.Tensor:
    group, _, _, _ = _resolve(axis, mesh)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, axis=DATA_AXIS, mesh=None) -> torch.Tensor:
    """Allreduce-sum over the axis — the `treeAggregate` replacement."""
    _note("psum", x)
    return _reduce(x, dist.ReduceOp.SUM, axis, mesh)


def psum_scalars(*xs, axis=DATA_AXIS, mesh=None) -> tuple:
    """ONE allreduce for several statistics of one shape: stacks them as
    float64 and sums the stack, so k reductions cost one call.
    Elementwise across ranks, so each result is its own psum. Returns
    the float64 sums in input order."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    stacked = psum(torch.stack([torch.as_tensor(x, dtype=torch.float64,
                                                device=dev) for x in xs]),
                   axis, mesh)
    return tuple(stacked[i] for i in range(len(xs)))


def pmean(x: torch.Tensor, axis=DATA_AXIS, mesh=None) -> torch.Tensor:
    _note("pmean", x)
    _, size, _, _ = _resolve(axis, mesh)
    return _reduce(x, dist.ReduceOp.SUM, axis, mesh) / size


def pmax(x: torch.Tensor, axis=DATA_AXIS, mesh=None) -> torch.Tensor:
    _note("pmax", x)
    return _reduce(x, dist.ReduceOp.MAX, axis, mesh)


def pmin(x: torch.Tensor, axis=DATA_AXIS, mesh=None) -> torch.Tensor:
    _note("pmin", x)
    return _reduce(x, dist.ReduceOp.MIN, axis, mesh)


def _all_gather(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Every rank's `x` end to end along dim 0 (host-staged under gloo)."""
    group, size, _, backend = _resolve(axis, mesh)
    src = x.contiguous()
    if _staged(src, backend):
        # torchlint: disable=host-sync-in-hot-path -- gloo all-gathers a CUDA payload only through host memory (PyTorch's backend table); NCCL never takes this branch
        return _all_gather(src.cpu(), axis, mesh).to(x.device)
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _dist("all_gather_single", "all_gather_into_tensor")(out, src,
                                                          group=group)
    return out


def all_gather(x: torch.Tensor, axis=DATA_AXIS, *, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """Every rank's `x`: stacked on a new leading axis, or end to end
    along dim 0 when `tiled`. Under gloo a CUDA payload goes through
    host memory."""
    _note("all_gather", x)
    if x.dim() == 0:
        x = x.reshape(1)
        tiled = True
    out = _all_gather(x if tiled else x.unsqueeze(0), axis, mesh)
    return out


def _reduce_scatter(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The sum over ranks of `x`, this rank's 1/size of dim 0 (host-staged
    under gloo)."""
    group, size, _, backend = _resolve(axis, mesh)
    src = x.contiguous()
    if _staged(src, backend):
        # torchlint: disable=host-sync-in-hot-path -- gloo reduce-scatters a CUDA payload only through host memory (PyTorch's backend table); NCCL never takes this branch
        return _reduce_scatter(src.cpu(), axis, mesh).to(x.device)
    if src.shape[0] % size:
        raise ValueError(f"dim 0 ({src.shape[0]}) does not divide over "
                         f"{size} ranks")
    out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _dist("reduce_scatter_single", "reduce_scatter_tensor")(out, src,
                                                            group=group)
    return out


def reduce_scatter(x: torch.Tensor, axis=DATA_AXIS, *,
                   scatter_dimension: int = 0, mesh=None) -> torch.Tensor:
    """The sum over ranks of `x`, of which this rank keeps block `index`
    of `scatter_dimension` (tiled). Under gloo a CUDA payload goes
    through host memory."""
    _note("reduce_scatter", x)
    moved = x.movedim(scatter_dimension, 0)
    return _reduce_scatter(moved, axis, mesh).movedim(0, scatter_dimension)


def all_to_all(x: torch.Tensor, axis=DATA_AXIS, *, split_axis: int = 0,
               concat_axis: int = 0, mesh=None) -> torch.Tensor:
    """Device-side shuffle: block j of `split_axis` goes to rank j, and
    the blocks received are joined along `concat_axis` in rank order
    (tiled). Under gloo a CUDA payload goes through host memory."""
    _note("all_to_all", x)
    group, size, _, backend = _resolve(axis, mesh)
    src = x.movedim(split_axis, 0).contiguous()
    if src.shape[0] % size:
        raise ValueError(f"split axis ({src.shape[0]}) does not divide "
                         f"over {size} ranks")
    work = src.cpu() if _staged(src, backend) else src
    out = torch.empty_like(work)
    dist.all_to_all_single(out, work, group=group)
    out = out.to(x.device)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(size, dim=0)]
    return torch.cat(blocks, dim=concat_axis)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             axis=DATA_AXIS, mesh=None) -> torch.Tensor:
    """Send `x` along each (source, destination) pair of axis indices;
    a rank that no pair sends to gets zeros. Under gloo a CUDA payload
    goes through host memory."""
    _note("ppermute", x)
    group, _, me, backend = _resolve(axis, mesh)
    src = x.contiguous()
    work = src.cpu() if _staged(src, backend) else src
    out = torch.zeros_like(work)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, work,
                                  dist.get_global_rank(group, d), group))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


def psum_hierarchical(x: torch.Tensor, *, ici_axis: str = ICI_AXIS,
                      dcn_axis: str = DCN_AXIS, ici_size: Optional[int] = None,
                      mesh=None) -> torch.Tensor:
    """Two-level allreduce for a host mesh:

      1. reduce-scatter over the intra-group hop (`ici_axis`): each of the
         `ici_size` group members ends holding the group's sum of one
         1/ici_size chunk of the payload;
      2. allreduce the chunk over the inter-group hop (`dcn_axis`), the
         only cross-host traffic: payload/ici_size bytes a rank instead
         of the full payload;
      3. allgather the reduced chunks back over `ici_axis`.

    The result equals `psum(x)` over the whole mesh, bit-exactly when
    the chunk sums are exact (integer-valued payloads), else within the
    order of the float sums. `ici_size` (the "ici" hop's rank count, read
    from the mesh when None) must match the mesh. The flattened payload is
    zero-padded to a multiple of it, exact for sums; an `ici_size` of 1
    is the flat psum over the "dcn" hop. Per-hop calls and bytes:
    the full payload on the ici reduce-scatter, payload/ici_size on the
    dcn allreduce and the ici allgather. Under gloo the two "ici" hops
    of a CUDA payload go through host memory."""
    _, per, _, _ = _resolve(ici_axis, mesh)
    if ici_size is not None and int(ici_size) != per:
        raise ValueError(f"ici_size {ici_size} != the mesh's {per}")
    dcn_group = _resolve(dcn_axis, mesh)[0]
    if per <= 1:
        _note("psum", x, "dcn")
        out = x.contiguous().clone()
        dist.all_reduce(out, group=dcn_group)
        return out
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    _note("psum", flat, "ici")
    chunk = _reduce_scatter(flat, ici_axis, mesh)
    _note("psum", chunk, "dcn")
    dist.all_reduce(chunk, group=dcn_group)
    _note("all_gather", chunk, "ici")
    out = _all_gather(chunk, ici_axis, mesh)
    return out[:n].reshape(x.shape)


def axis_index(axis=DATA_AXIS, mesh=None) -> int:
    """This rank's index on one axis, or on the ("dcn", "ici") pair (its
    flat position: group * ici size + position in the group, the flat
    mesh's index)."""
    return _resolve(axis, mesh)[2]


def masked_count(mask: torch.Tensor, axis=DATA_AXIS,
                 mesh=None) -> torch.Tensor:
    """Global true-row count given each rank's 0/1 row mask."""
    return psum(mask.sum(), axis, mesh)


def all_gather_object(obj, axis=DATA_AXIS, mesh=None) -> list:
    """Every rank's picklable `obj` on the axis, in rank order (pickled
    through the mesh's backend)."""
    _note("all_gather_object")
    group, size, _, _ = _resolve(axis, mesh)
    out: list = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out


class MultihostInitError(RuntimeError):
    """Typed failure surface of `initialize_multihost`: carries the
    coordinator / process context so a wedged bring-up is diagnosable
    from the exception alone (which peer config, which process slot,
    which backend)."""

    def __init__(self, msg: str, *, coordinator=None, num_processes=None,
                 process_id=None, backend=None):
        super().__init__(msg)
        self.coordinator = coordinator
        self.num_processes = num_processes
        self.process_id = process_id
        self.backend = backend


def _env_int(name: str) -> Optional[int]:
    import os
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


#: the default group `initialize_multihost` made, until the exit hook
#: takes it down (a list, so that the hook holds no reference of its own)
_OWNED: list = []
_hooked = [False]


def _shutdown() -> None:
    """The exit hook of `initialize_multihost`: while the default group
    it made is still the default group, a barrier over its ranks
    (bounded by the group's timeout) and `destroy_process_group()`;
    then `mesh.release()` drops the meshes that still hold a group, so
    that the group is freed and its threads joined now. A group that a
    cached mesh held was freed at interpreter teardown instead, where it
    could abort ("terminate called without an active exception"). A
    group already destroyed, or replaced, is not destroyed here; an exit
    on an uncaught exception skips the hook (its peers may be inside
    another collective, which the barrier would wait out); a barrier
    that fails (a peer gone first) is reported and the group destroyed
    all the same."""
    owned = _OWNED.pop() if _OWNED else None
    if getattr(sys, "last_value", None) is not None:
        return
    if dist.is_available() and dist.is_initialized() \
            and owned is not None and dist.group.WORLD is owned:
        del owned
        try:
            # torchlint: disable=divergent-collective -- the exit hook skips the barrier on an exit by an uncaught exception (sys.last_value), by design: that rank's peers may be inside another collective, and the group's timeout bounds the others' wait
            dist.barrier()
        except RuntimeError as e:   # at exit: report, then tear down
            print(f"sml_tpu_torch: exit barrier failed: {e}",
                  file=sys.stderr)
        dist.destroy_process_group()
    _mesh.release()


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         timeout_s: float = 300.0,
                         backend: Optional[str] = None,
                         device=None) -> bool:
    """Bring up the default process group of `num_processes` ranks, this
    process as rank `process_id`, and bind this rank's device
    (`mesh.bind_rank_device`). Without arguments it reads torchrun's
    variables (WORLD_SIZE, RANK, LOCAL_RANK, and MASTER_ADDR /
    MASTER_PORT through "env://"). With one process (or none) it
    returns False and touches nothing; else True. At interpreter exit
    the group it made is taken down once (`_shutdown`).

    `coordinator` is "host:port" (tcp) or a full init URL ("tcp://...",
    "file://..."). The device is `device`, else `cuda:LOCAL_RANK` (the
    process id without torchrun); a CUDA device becomes the process's
    current device. The backend is the caller's: a CUDA
    device takes NCCL unless `backend="gloo"`, a CPU device gloo. A
    failure (a timeout after `timeout_s`, a refused coordinator, a
    second init, NCCL without a card) raises `MultihostInitError`,
    chained to the original error; it never retries on another
    backend. Bring-up blocks until every rank joins, under the
    watchdog's `collective.initialize` ticket."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if num_processes is None or num_processes <= 1:
        return False
    local = _env_int("LOCAL_RANK")
    init = ("env://" if coordinator is None else coordinator
            if "://" in coordinator else f"tcp://{coordinator}")
    chosen = backend
    with _WATCHDOG.watch("collective", "collective.initialize",
                         trace=_trace.current()):
        try:
            dev = torch.device(device) if device is not None else \
                torch.device("cuda", local if local is not None
                             else int(process_id or 0))
            chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
            if dev.type == "cuda":
                from ..device import resolve_device
                dev = resolve_device(dev)   # no card: raises
            kwargs = dict(backend=chosen, init_method=init,
                          world_size=int(num_processes), rank=process_id,
                          timeout=timedelta(seconds=float(timeout_s)))
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            if chosen == "nccl":
                kwargs["device_id"] = dev
            dist.init_process_group(**kwargs)
        except (RuntimeError, ValueError, OSError) as e:
            raise MultihostInitError(
                f"multi-host bring-up failed (coordinator={coordinator!r}, "
                f"num_processes={num_processes}, process_id={process_id}, "
                f"backend={chosen!r}, timeout_s={timeout_s}): {e}",
                coordinator=coordinator, num_processes=num_processes,
                process_id=process_id, backend=chosen) from e
    _mesh.bind_rank_device(dev)
    _OWNED[:] = [dist.group.WORLD]
    if not _hooked[0]:
        atexit.register(_shutdown)
        _hooked[0] = True
    return True
