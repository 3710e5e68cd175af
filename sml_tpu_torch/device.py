"""The device of the port's entry points.

On one card there is no sharding and no collective: a caller names a
device, or gets the CUDA card. (A mesh of ranks, one device each, is
`parallel/mesh.py`, the counterpart of `sml_tpu/parallel/mesh.py`.)
Entry points run on the card unless the caller asks for the CPU; asking
for CUDA where there is none raises instead of carrying on somewhere
else.

`run_placed_trials` is the one-card form of the JAX package's placed
trials: tuning's trials run `parallelism` worker threads wide, all on
the session's device.

`use_device_local(device)` binds a device as THIS thread's (the JAX
package's `use_mesh_local`): inside it `resolve_device(None)` and
`session_device()` answer the bound device. Under a mesh of ranks an
unbound thread's device is the mesh's (this rank's), not
`torch.cuda.current_device()`. The dispatcher's `routed`
binds its choice this way, so a fit routed to the host stages, launches
and reads back on the CPU without the call sites below it passing a
device; other threads keep theirs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Union

import torch

_tls = threading.local()


@contextlib.contextmanager
def use_device_local(device: Union[str, torch.device]):
    """Bind `device` as this thread's device for the block (nested
    bindings restore the outer one on exit)."""
    prev = getattr(_tls, "device", None)
    _tls.device = torch.device(device)
    try:
        yield _tls.device
    finally:
        _tls.device = prev


def bound_device() -> Optional[torch.device]:
    """This thread's bound device (`use_device_local`), else None."""
    return getattr(_tls, "device", None)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a `torch.device`; None means this thread's bound
    device (`use_device_local`), else the active mesh's device (this
    rank's), else the CUDA card.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and this process has no usable CUDA device."""
    if device is None:
        device = bound_device()
    if device is None:
        from .parallel.mesh import get_mesh
        mesh = get_mesh()
        device = None if mesh is None else mesh.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to this process; the port runs "
            "on the card by default — pass device='cpu' to run the plain "
            "PyTorch versions on the host instead")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def session_device() -> torch.device:
    """The device of the DataFrame entry points: this thread's bound
    device (`use_device_local`), else the `sml.device` key, through
    `resolve_device` (so a missing card raises)."""
    from .conf import GLOBAL_CONF
    bound = bound_device()
    return resolve_device(bound if bound is not None
                          else GLOBAL_CONF.get("sml.device"))


def run_placed_trials(jobs: Sequence, fn: Callable, parallelism: int
                      ) -> List:
    """`fn(job)` for every job, `parallelism` worker threads wide, all on
    the session's device (one card has one layout; the JAX package gives
    each worker its own submesh). Results come back in job order. An
    exception in a trial propagates. Under a mesh of several ranks,
    trials in threads would interleave their fits' collectives, so
    parallelism above 1 raises there (trials over ranks: ROADMAP item
    10)."""
    jobs = list(jobs)
    session_device()  # no card: raise before any trial starts
    parallelism = max(1, int(parallelism))
    if parallelism > 1 and len(jobs) > 1:
        from .parallel.mesh import data_width
        if data_width() > 1:
            raise NotImplementedError(
                "placed trials in threads under a mesh of several ranks "
                "would interleave their collectives; run them with "
                "parallelism 1 (trials over ranks: ROADMAP item 10)")
    if parallelism <= 1 or len(jobs) <= 1:
        return [fn(job) for job in jobs]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(parallelism, len(jobs))) as pool:
        return list(pool.map(fn, jobs))
